"""The 2D dense-CRF demo with the whole problem built on the device.

Counterpart of ``rovinasemanticsegmentation_tpu/models/crf2d_device.py``,
the device-build path of ``cli/dense_inference`` (the densecrf example
``dense_inference.cpp:54-115``). From the [H, W, 3] uint8 image and the [N]
annotation labels it makes, on the tensors' device: the pairwise features
(``densecrf.cpp:61-81``), both permutohedral lattices
(:func:`~.lattice.build_lattice_device`), their symmetric normalisations
(``pairwise.cpp:46-61``), the unary energies (``dense_inference.cpp:37-52``),
the mean field (``densecrf.cpp:115-131``) in the transposed [C, N] layout,
and the first-max MAP argmax (``:202-211``).

The sorted-stream splat sums each vertex's contributions in sorted order, so
the marginals differ from the host-build path (:class:`~.crf.DenseCRF2D`)
by float32 rounding only.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .crf import normalize_blocks
from .lattice import build_lattice_device, lattice_filter_t


def _div(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x / scale`` as XLA compiles a division by a constant: a multiply by
    the float32 reciprocal. The lattice keys hang on the features' last
    bit, and a true division differs on about a third of the pixels."""
    return x * torch.tensor(np.float32(1.0) / np.float32(scale), device=x.device)


def _dense2d_device_impl(
    im: torch.Tensor,  # [H, W, 3] uint8
    labels: torch.Tensor,  # [N] int8/int32, -1 = unknown
    energies: torch.Tensor,  # [3] float32 (u, n, p)
    h: int,
    w: int,
    num_labels: int,
    n_iterations: int,
    m_buckets: Tuple[int, int],
    params: Tuple[Tuple[float, ...], Tuple[float, ...]],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Features -> lattices -> norms -> mean field -> MAP, no host read.

    ``params`` = ((sx, sy, w_gauss), (bsx, bsy, sr, sg, sb, w_bilat)), the
    demo's kernel scales and Potts weights (dense_inference.cpp:83-97).
    Returns (map labels [N] int32, vertex counts [2] int32); a count above
    its bucket means that build overflowed, and the caller must run again
    with a larger bucket.
    """
    (sx, sy, wg), (bsx, bsy, sr, sg, sb, wb) = params
    n = h * w
    dev = im.device
    xs = torch.arange(w, dtype=torch.float32, device=dev).repeat(h)
    ys = torch.arange(h, dtype=torch.float32, device=dev).repeat_interleave(w)
    rgb = im.reshape(n, 3).float()
    feats_g = torch.stack([_div(xs, sx), _div(ys, sy)], dim=1)
    feats_b = torch.stack(
        [_div(xs, bsx), _div(ys, bsy), _div(rgb[:, 0], sr),
         _div(rgb[:, 1], sg), _div(rgb[:, 2], sb)],
        dim=1,
    )
    kernels, counts = [], []
    ones = torch.ones((1, n), device=dev)
    for feats, bucket, weight in ((feats_g, m_buckets[0], wg),
                                  (feats_b, m_buckets[1], wb)):
        *lattice, m = build_lattice_device(feats, bucket)
        counts.append(m)
        raw = lattice_filter_t(ones, *lattice, bucket)[0]
        kernels.append((lattice, bucket, 1.0 / torch.sqrt(raw + 1e-20), weight))

    # Unary energies from the label map (dense_inference.cpp:37-52), [C, N].
    lab = labels.long()
    base = torch.where(lab >= 0, energies[1], energies[0])[None, :]
    onehot = lab[None, :] == torch.arange(num_labels, device=dev)[:, None]
    unary_t = torch.where(onehot, energies[2], base)

    q = normalize_blocks(-unary_t, (num_labels,))
    for _ in range(n_iterations):
        tmp = -unary_t
        for lattice, bucket, norm, weight in kernels:
            out = lattice_filter_t(q * norm, *lattice, bucket) * norm
            # Potts apply is -w out; the step subtracts it (densecrf.cpp:121).
            tmp = tmp + weight * out
        q = normalize_blocks(tmp, (num_labels,))
    map_labels = torch.argmax(q, dim=0).to(torch.int32)
    return map_labels, torch.stack(counts).to(torch.int32)


def dense2d_map_from_labels_device(
    im: np.ndarray,  # [H, W, 3] uint8
    labels: np.ndarray,  # [N] int, -1 = unknown
    energies: Tuple[float, float, float],
    num_labels: int,
    n_iterations: int,
    gauss: Sequence[float] = (3.0, 3.0, 3.0),
    bilateral: Sequence[float] = (80.0, 80.0, 13.0, 13.0, 13.0, 10.0),
    m_bucket: int = 1 << 14,
    *,
    device: torch.device | str,
) -> np.ndarray:
    """MAP labels [N] of the demo CRF on ``device``, with the bucket retry:
    a kernel whose vertex count overflows its bucket runs again with 4x the
    slots. The vertex counts are the loop's one host read."""
    dev = resolve_device(device)
    h, w = im.shape[:2]
    im_dev = torch.from_numpy(np.ascontiguousarray(im)).to(dev)
    dtype = np.int8 if num_labels < 128 else np.int32
    lab_dev = torch.from_numpy(np.asarray(labels).astype(dtype)).to(dev)
    e_dev = torch.tensor(energies, dtype=torch.float32, device=dev)
    params = (tuple(map(float, gauss)), tuple(map(float, bilateral)))
    buckets = [m_bucket, m_bucket]
    while True:
        out, counts = _dense2d_device_impl(
            im_dev, lab_dev, e_dev, h, w, num_labels, n_iterations,
            tuple(buckets), params,
        )
        over = counts.cpu().numpy() > np.asarray(buckets)
        if not over.any():
            return out.cpu().numpy()
        for k in np.nonzero(over)[0]:
            buckets[int(k)] *= 4
