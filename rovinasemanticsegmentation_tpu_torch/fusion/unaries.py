"""Accumulation of per-frame posteriors into per-point map unaries.

Counterpart of ``rovinasemanticsegmentation_tpu/fusion/unaries.py``, the
fusion inner loop (``segmenter.cpp:599-616``): for one camera's index image,
every pixel that hit a cloud point adds its per-class posterior to that
point's unary row; missing frames contribute nothing (``:618-621``).

Several pixels may hit one point, so a scatter-add (``index_add_``) would
sum them with float atomics in an order that changes from run to run on a
GPU. Instead the pixels are stable-sorted by point index and each point
takes the range difference of a prefix sum over the sorted stream, which
gives the same sums on every run.
"""

from __future__ import annotations

import torch

from ..models.lattice import segment_sum_sorted_t


def accumulate_unaries(
    unaries: torch.Tensor,  # [N, C] running accumulator
    posterior: torch.Tensor,  # [H, W, C] full-resolution posterior
    index_image: torch.Tensor,  # [H, W] cloud index or -1
    num_points: int,
) -> torch.Tensor:  # [N, C]
    """``unaries`` plus each point's sum of the posteriors of its pixels."""
    c = posterior.shape[-1]
    idx = index_image.reshape(-1).long()
    vals = posterior.reshape(-1, c)
    safe = torch.where(idx >= 0, idx, num_points)  # misses go past the points
    ids, order = torch.sort(safe, stable=True)
    points = torch.arange(num_points, device=idx.device)
    starts = torch.searchsorted(ids, points, right=False)
    ends = torch.searchsorted(ids, points, right=True)
    sums = segment_sum_sorted_t(vals[order].T, starts, ends)
    return unaries + sums.T
