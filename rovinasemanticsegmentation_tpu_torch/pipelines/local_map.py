"""Local-map segmentation: fuse per-frame posteriors into per-point labels.

Counterpart of ``rovinasemanticsegmentation_tpu/pipelines/local_map.py``
with the dense CRF off, after the map-fusion worker
``Segmenter::processMapFromQueue`` (``segmenter.cpp:518-719``):

1. per keyframe node, z-buffer-project the cloud into the stacked camera
   image (``:578``) and add the winner pixels' frame posteriors into
   per-point unaries (``:589-616``); a missing frame contributes nothing
   (``:618-621``);
2. plain argmax of the summed unaries with a -1000 floor; all-zero rows get
   the layer's Unknown label (``:659-682``).

The dense-CRF branch (``:628-658``) is not ported yet: ``use_dense_crf=True``
raises (ROADMAP.md queue 1, items 1.8-1.10).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..fusion.projector import MultiProjector, project_winners


@dataclass
class CrfParams:
    """resources/config.json:81-85."""

    use_dense_crf: bool = False
    xyz_kernel: float = 0.5
    rgb_kernel: float = 4.0
    kernel_weight: float = 10.0
    iterations: int = 10

    def __post_init__(self):
        if self.use_dense_crf:
            raise NotImplementedError(
                "use_dense_crf=True: the dense CRF (permutohedral lattice and "
                "mean field) is not ported to PyTorch yet -- ROADMAP.md queue "
                "1, items 1.8-1.10; run with use_dense_crf false"
            )


@dataclass
class MapNodeFrames:
    """One keyframe node: its pose and per-camera full-resolution posteriors.

    ``posteriors[camera][layer]`` is an [H, W, C_l] tensor, or None when the
    frame's segmentation is missing (tolerated, segmenter.cpp:618-621).
    """

    pose: np.ndarray  # [4, 4] keyframe transform
    posteriors: List[Optional[List[torch.Tensor]]]


def plain_labels(unaries: torch.Tensor, unknown_label: int) -> torch.Tensor:
    """Argmax with -1000 floor; all-zero rows -> Unknown (segmenter.cpp:659-682)."""
    lbl = torch.argmax(unaries, dim=1)
    unknown = torch.full_like(lbl, unknown_label)
    lbl = torch.where(torch.amax(unaries, dim=1) > -1000.0, lbl, unknown)
    return torch.where(unaries.sum(dim=1) == 0.0, unknown, lbl).to(torch.int32)


class LocalMapPipeline:
    """Fusion and labelling of local maps on one device."""

    def __init__(
        self,
        projector: MultiProjector,
        class_counts: Sequence[int],
        unknown_labels: Sequence[int],
        device: torch.device | str,
    ):
        self.projector = projector
        self.class_counts = [int(c) for c in class_counts]
        self.unknown_labels = [int(u) for u in unknown_labels]
        self.device = resolve_device(device)
        self._intrinsics = torch.from_numpy(projector.intrinsics).to(self.device)

    def fuse_unaries(
        self, cloud_points, nodes: Sequence[MapNodeFrames]
    ) -> List[torch.Tensor]:
        """Per-layer [N, C_l] unary sums over the nodes (segmenter.cpp:561-626)."""
        proj = self.projector
        dev = self.device
        points = torch.as_tensor(
            np.asarray(cloud_points, np.float32), device=dev
        )
        n = points.shape[0]
        ncam = proj.intrinsics.shape[0]
        npix = ncam * proj.height * proj.width
        ctot = sum(self.class_counts)
        fused = torch.zeros((n, ctot), dtype=torch.float32, device=dev)
        for node in nodes:
            cams = [
                node.posteriors[c] if c < len(node.posteriors) else None
                for c in range(ncam)
            ]
            if all(layers is None for layers in cams):
                continue  # zero posteriors add nothing
            rot, trans = proj.camera_transforms(node.pose)
            won, flat = project_winners(
                points, torch.from_numpy(rot).to(dev),
                torch.from_numpy(trans).to(dev), self._intrinsics,
                proj.min_distance, proj.max_distance, proj.height, proj.width,
            )
            post = torch.cat(
                [
                    torch.zeros(
                        (proj.height, proj.width, ctot), dtype=torch.float32,
                        device=dev,
                    )
                    if layers is None
                    else torch.cat([torch.as_tensor(p, device=dev)
                                    for p in layers], dim=-1)
                    for layers in cams
                ],
                dim=0,
            ).reshape(-1, ctot)  # [C3*H*W, Ctot]
            # Multiply (not select) by the winner mask, as the reference does.
            contrib = post[torch.clamp(flat, max=npix - 1)] * won[:, None]
            fused = fused + contrib.reshape(ncam, n, ctot).sum(dim=0)
        unaries, start = [], 0
        for c in self.class_counts:
            unaries.append(fused[:, start : start + c])
            start += c
        return unaries

    def label_map(self, unaries: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Per-layer int32 point labels on the device."""
        return [
            plain_labels(u, unk) for u, unk in zip(unaries, self.unknown_labels)
        ]

    def run_device(
        self, cloud_points, cloud_rgb, nodes: Sequence[MapNodeFrames]
    ) -> List[torch.Tensor]:
        """Fusion + labels for one map, left on the device.

        ``cloud_rgb`` feeds only the dense CRF, which is not ported.
        """
        del cloud_rgb
        return self.label_map(self.fuse_unaries(cloud_points, nodes))

    def run(
        self, cloud_points, cloud_rgb, nodes: Sequence[MapNodeFrames]
    ) -> List[np.ndarray]:
        """Fusion + labels for one map, as per-layer uint8 numpy arrays."""
        return [
            lbl.cpu().numpy().astype(np.uint8)
            for lbl in self.run_device(cloud_points, cloud_rgb, nodes)
        ]
