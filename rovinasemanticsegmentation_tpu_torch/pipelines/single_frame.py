"""Single-frame segmentation: features -> forest -> per-pixel posteriors.

Counterpart of ``rovinasemanticsegmentation_tpu/pipelines/single_frame.py``,
mirroring the offline evaluator (``test_multi.cpp:154-237``) and the online
per-keyframe worker (``segmenter.cpp:323-443``):

1. extract stride-grid features;
2. forest log-posterior per grid point (``ops/forest_cuda.py``: the CUDA
   descent kernel on a CUDA device, its plain version on the CPU);
3. per-layer posterior maps at stride resolution, ``fill_value`` where
   masked (-1000 offline, ``test_multi.cpp:181``; 0 online,
   ``segmenter.cpp:358-362``);
4. bilinear resize of each map to full resolution (``test_multi.cpp:199``);
5. per-pixel argmax with a -1000 floor: -1 where nothing beats it
   (``test_multi.cpp:206-216``).

Steps 3-5 are one kernel launch a frame on a CUDA device
(``ops/resize_argmax_cuda.py``), their plain version on the CPU.

A batch of frames runs the descent once over one buffer of packed feature
rows (``[B*P, row_bytes]`` uint8, ``ops/feature_rows.py``): kernel A writes
each frame's patch bytes into it and the descent reads it there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..features.extractor import (
    FeatureConfig,
    extract_feature_rows,
    feature_row_layout,
    to_device_depth,
    to_device_image,
)
from ..models.forest import TorchForest, forest_from_numpy
from ..ops import resize_argmax_cuda
from ..ops.forest_cuda import forest_predict_rows
from ..ops.resize import resize_bilinear
from ..utils.calibration import Calibration
from ..utils.profiling import span

ARGMAX_FLOOR = -1000.0  # test_multi.cpp:181,207


def posterior_maps(
    post: torch.Tensor,  # [P, L, C_max]
    mask: torch.Tensor,  # [P] bool
    grid_shape: Tuple[int, int],
    class_counts: Sequence[int],
    fill_value: float,
    out_h: int,
    out_w: int,
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Stride posteriors -> full-resolution maps and argmax labels per layer.

    A CUDA tensor goes through one kernel launch (``csrc/resize_argmax.cu``),
    bit-equal to :func:`posterior_maps_plain`, which raises ``ValueError`` for
    what the kernel does not take; a CPU tensor runs the plain version."""
    if resize_argmax_cuda.engages(post):
        return resize_argmax_cuda.posterior_maps(
            post, mask, grid_shape, class_counts, fill_value, out_h, out_w)
    return posterior_maps_plain(post, mask, grid_shape, class_counts,
                                fill_value, out_h, out_w)


def posterior_maps_plain(
    post: torch.Tensor,
    mask: torch.Tensor,
    grid_shape: Tuple[int, int],
    class_counts: Sequence[int],
    fill_value: float,
    out_h: int,
    out_w: int,
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """:func:`posterior_maps` in PyTorch ops: the masked fill, the resize and
    the floored argmax of each layer."""
    gh, gw = grid_shape
    posteriors, labels = [], []
    for li, c in enumerate(class_counts):
        layer = torch.where(
            mask[:, None], post[:, li, :c],
            torch.full((), fill_value, dtype=torch.float32, device=post.device),
        )
        full = resize_bilinear(layer.reshape(gh, gw, c), out_h, out_w)
        lbl = torch.argmax(full, dim=-1).to(torch.int8)  # first max on ties
        lbl = torch.where(
            torch.amax(full, dim=-1) > ARGMAX_FLOOR, lbl,
            torch.full_like(lbl, -1),
        )
        posteriors.append(full)
        labels.append(lbl)
    return posteriors, labels


@dataclass
class SingleFrameResult:
    posteriors: List[torch.Tensor]  # per layer [H, W, C_l] float32
    labels: List[torch.Tensor]  # per layer [H, W] int8 (-1 = no vote)


class SingleFramePipeline:
    """features -> forest -> posterior maps -> labels for calibrated cameras."""

    def __init__(
        self,
        feature_config: FeatureConfig,
        forest,
        stride: int,
        device: torch.device | str,
        fill_value: float = ARGMAX_FLOOR,
    ):
        """``forest`` is a :class:`TorchForest` or any object with the
        reference ``Forest`` fields (converted onto ``device``)."""
        self.device = resolve_device(device)
        self.feature_config = feature_config
        self.stride = int(stride)
        self.fill_value = float(fill_value)
        if not isinstance(forest, TorchForest):
            forest = forest_from_numpy(forest, self.device)
        if forest.device != self.device:
            raise ValueError(
                f"forest on {forest.device}, pipeline on {self.device}"
            )
        self.forest = forest
        self.class_counts = tuple(forest.class_counts)

    def run(
        self, rgb: np.ndarray, depth_mm: np.ndarray, calibration: Calibration
    ) -> SingleFrameResult:
        return self.run_batch([rgb], [depth_mm], [calibration])[0]

    def run_batch(
        self,
        rgbs: Sequence[np.ndarray],
        depths_mm: Sequence[np.ndarray],
        calibrations: Sequence[Calibration],
    ) -> List[SingleFrameResult]:
        """B keyframes with one descent; per-frame outputs equal :meth:`run`'s."""
        dev = self.device
        return self.run_batch_stacked(
            torch.stack([to_device_image(r, dev) for r in rgbs]),
            torch.stack([to_device_depth(d, dev) for d in depths_mm]),
            np.stack([np.asarray(c.intrinsic_inverse) for c in calibrations]),
            np.stack([np.asarray(c.rotation) for c in calibrations]),
            np.stack([np.asarray(c.translation) for c in calibrations]),
        )

    def run_batch_stacked(
        self,
        rgb_stack,  # [B, H, W, 3] uint8 (host or device)
        depth_stack,  # [B, H, W] depth in mm
        kinv_stack,  # [B, 3, 3]
        rot_stack,  # [B, 3, 3]
        trans_stack,  # [B, 3]
    ) -> List[SingleFrameResult]:
        post, masks = self.stacked_posteriors(
            rgb_stack, depth_stack, kinv_stack, rot_stack, trans_stack)
        with span("frame.results"):
            return self.results(post, masks, tuple(depth_stack.shape[1:]))

    def stacked_posteriors(
        self, rgb_stack, depth_stack, kinv_stack, rot_stack, trans_stack,
    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """Features and the descent of a batch: -> (log-posterior
        ``[B*P, L, C_max]`` summed over this pipeline's trees, per-frame masks
        ``[P]``)."""
        dev = self.device
        rgb_stack = to_device_image(rgb_stack, dev)
        depth_stack = to_device_depth(depth_stack, dev)
        kinv, rot, trans = (
            torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in (kinv_stack, rot_stack, trans_stack)
        )
        b, h, w = depth_stack.shape
        gh, gw = self.grid_shape(h, w)
        p = gh * gw
        # One packed row buffer for the batch: each frame's features are
        # written into it in place, and the descent reads it.
        layout = feature_row_layout(self.feature_config)
        rows = torch.empty((b * p, layout.row_bytes), dtype=torch.uint8,
                           device=dev)
        masks = [
            extract_feature_rows(
                rgb_stack[i], depth_stack[i], kinv[i], rot[i], trans[i],
                self.feature_config, self.stride, rows, i * p,
            )
            for i in range(b)
        ]
        with span("frame.descent"):
            _, post = forest_predict_rows(rows, layout, self.forest)
        return post, masks

    def grid_shape(self, h: int, w: int) -> Tuple[int, int]:
        return -(-h // self.stride), -(-w // self.stride)

    def results(
        self, post: torch.Tensor, masks: Sequence[torch.Tensor],
        frame_shape: Tuple[int, int],
    ) -> List[SingleFrameResult]:
        """Per-frame posterior maps and labels from :meth:`stacked_posteriors`."""
        h, w = frame_shape
        grid_shape = self.grid_shape(h, w)
        p = grid_shape[0] * grid_shape[1]
        results = []
        for i, mask in enumerate(masks):
            posteriors, labels = posterior_maps(
                post[i * p : (i + 1) * p], mask, grid_shape,
                self.class_counts, self.fill_value, h, w,
            )
            results.append(SingleFrameResult(posteriors, labels))
        return results
