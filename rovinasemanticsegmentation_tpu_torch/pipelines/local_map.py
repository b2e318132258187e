"""Local-map segmentation: fuse per-frame posteriors, smooth, label points.

Counterpart of ``rovinasemanticsegmentation_tpu/pipelines/local_map.py``,
after the map-fusion worker ``Segmenter::processMapFromQueue``
(``segmenter.cpp:518-719``):

1. per keyframe node, z-buffer-project the cloud into the stacked camera
   image (``:578``) and add the winner pixels' frame posteriors into
   per-point unaries (``:589-616``); a missing frame contributes nothing
   (``:618-621``);
2. with the dense CRF on (``:628-658``): pairwise features
   ``[xyz * dcrf_xyz_kernel ; rgb * dcrf_rgb_kernel]`` (cloud RGB in [0, 1]),
   a permutohedral lattice over them, one Potts CRF per layer with weight
   ``dcrf_kernel_weight`` run for ``dcrf_iterations`` mean-field steps, then
   argmax with a ``2/C`` confidence floor defaulting to the layer's Unknown
   label (``:645-657``);
3. otherwise plain argmax of the summed unaries with a -1000 floor; all-zero
   rows get the layer's Unknown label (``:659-682``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..fusion.projector import MultiProjector, project_winners
from ..models.crf import potts_mean_field_multi_t
from ..models.lattice import (
    attach_sorted_stream,
    build_lattice,
    build_lattice_device,
    lattice_filter_t,
    lattice_tensors,
    pad_lattice,
)


@dataclass
class CrfParams:
    """resources/config.json:81-85."""

    use_dense_crf: bool = False
    xyz_kernel: float = 0.5
    rgb_kernel: float = 4.0
    kernel_weight: float = 10.0
    iterations: int = 10


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


def crf_feats(points, rgb, xyz_kernel: float, rgb_kernel: float) -> torch.Tensor:
    """CRF pairwise features [xyz * 0.5 ; rgb * 4.0] (segmenter.cpp:629-637)."""
    return torch.cat([points * xyz_kernel, rgb * rgb_kernel], dim=1)


def crf_labels_multi(
    unaries: torch.Tensor,  # [N, sum(blocks)] all layers' unaries
    lattice: Sequence[torch.Tensor],  # the 8 tensors of build_lattice_device
    weight: float,
    blocks: Sequence[int],
    num_vertices: int,
    n_iterations: int,
    unknown_labels: Sequence[int],
    overflow: Optional[torch.Tensor] = None,  # device bool: bucket overflow
) -> List[torch.Tensor]:
    """All layers' int32 labels from one fused mean field.

    The symmetric normalisation is ``1/sqrt(filter(ones))``
    (pairwise.cpp:54-56), the energy ``-unaries`` (``setUnaryEnergy``,
    segmenter.cpp:642). A layer whose marginal does not pass ``2/C`` gets its
    Unknown label (segmenter.cpp:645-657); ``overflow`` sets every label of
    every layer to Unknown.
    """
    n = unaries.shape[0]
    raw = lattice_filter_t(unaries.new_ones((1, n)), *lattice, num_vertices)[0]
    norm = 1.0 / torch.sqrt(raw + 1e-20)
    q = potts_mean_field_multi_t(
        -unaries.T, *lattice, norm, weight, blocks, num_vertices, n_iterations
    )
    out = []
    for ql, c, unk in zip(torch.split(q, list(blocks)), blocks, unknown_labels):
        floor = torch.tensor(2.0 / c, dtype=torch.float32)
        lbl = torch.where(ql.amax(dim=0) > floor, ql.argmax(dim=0), unk)
        if overflow is not None:
            lbl = torch.where(overflow, unk, lbl)
        out.append(lbl.to(torch.int32))
    return out


class _VertexCountProbe:
    """A map's device vertex count, read without blocking the map path.

    On a GPU the count is copied without blocking into pinned host memory
    and an event is recorded after the copy; on the CPU it is ready at once.
    """

    def __init__(self, bucket: int, count: torch.Tensor):
        self.bucket = bucket
        self._event = None
        self._host = count
        if count.is_cuda:
            self._host = torch.empty((), dtype=count.dtype, pin_memory=True)
            self._host.copy_(count, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def value(self) -> int:
        if self._event is not None:
            self._event.synchronize()
        return int(self._host)


class LocalMapPipeline:
    """Fusion, dense-CRF smoothing and labelling of local maps on one device.

    Vertex bucket policy of the device lattice build: the bucket starts at
    2^14 vertex slots. The first map of each cloud size synchronises once
    on its vertex count and doubles the bucket while the count exceeds 80%
    of it; later maps of a checked size run without a synchronisation. A
    map whose count still overflows is labelled all Unknown on the device,
    and its count is read back later (``_drain_overflow_flags``), which
    grows the bucket so that the following maps recover.
    """

    def __init__(
        self,
        projector: MultiProjector,
        class_counts: Sequence[int],
        unknown_labels: Sequence[int],
        device: torch.device | str,
        crf: CrfParams = CrfParams(),
        use_device_lattice: bool = True,
    ):
        self.projector = projector
        self.class_counts = [int(c) for c in class_counts]
        self.unknown_labels = [int(u) for u in unknown_labels]
        self.device = resolve_device(device)
        self.crf = crf
        self.use_device_lattice = bool(use_device_lattice)
        self._intrinsics = torch.from_numpy(projector.intrinsics).to(self.device)
        self._m_bucket = 1 << 14  # vertex slots of the device build
        self._m_checked = set()  # cloud sizes whose bucket was validated
        self._pending_m: List[_VertexCountProbe] = []

    def fuse_unaries(
        self, cloud_points, nodes: Sequence[MapNodeFrames]
    ) -> List[torch.Tensor]:
        """Per-layer [N, C_l] unary sums over the nodes (segmenter.cpp:561-626)."""
        proj = self.projector
        dev = self.device
        points = torch.as_tensor(cloud_points, dtype=torch.float32, device=dev)
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
        """Per-layer int32 point labels on the device, dense CRF off."""
        return [
            plain_labels(u, unk) for u, unk in zip(unaries, self.unknown_labels)
        ]

    def map_fused(
        self, points: torch.Tensor, cloud_rgb: torch.Tensor,
        nodes: Sequence[MapNodeFrames], m_bucket: int,
    ):
        """The whole map path with the dense CRF on: fusion, lattice build,
        fused mean field, labels (the JAX package's ``_map_fused``).

        The lattice is built on the device with ``m_bucket`` vertex slots,
        or with ``use_device_lattice=False`` on the host (native builder,
        padded, sorted stream) and uploaded. Returns ``(labels, m)``: the
        per-layer int32 labels and the device build's vertex count (None for
        the host build), both left on the device without a synchronisation.
        """
        fused = torch.cat(self.fuse_unaries(points, nodes), dim=1)
        feats = crf_feats(points, cloud_rgb, self.crf.xyz_kernel,
                          self.crf.rgb_kernel)
        if self.use_device_lattice:
            *lattice, m = build_lattice_device(feats, m_bucket)
            num_vertices, overflow = m_bucket, m > m_bucket
        else:
            host = attach_sorted_stream(
                pad_lattice(build_lattice(feats.cpu().numpy()))
            )
            lattice = lattice_tensors(host, self.device)
            num_vertices, m, overflow = host.num_vertices, None, None
        labels = crf_labels_multi(
            fused, lattice, self.crf.kernel_weight, self.class_counts,
            num_vertices, self.crf.iterations, self.unknown_labels, overflow,
        )
        return labels, m

    def _drain_overflow_flags(self, blocking: bool = False) -> None:
        """Read the vertex counts of finished maps without blocking.

        A map that ran without a synchronisation and overflowed its bucket
        was labelled all Unknown on the device; here its count is seen, the
        bucket grows to at least 1.25x it, and the checked sizes are cleared
        so that the next map of each size synchronises again.
        ``blocking=True`` waits for every pending count (:meth:`flush`).
        """
        still_pending = []
        overflow_max = 0
        for probe in self._pending_m:
            if not blocking and not probe.ready():
                still_pending.append(probe)
                continue
            count = probe.value()
            if count > probe.bucket:
                overflow_max = max(overflow_max, count)
        self._pending_m = still_pending
        if overflow_max:
            while self._m_bucket < overflow_max * 1.25:
                self._m_bucket *= 2
            self._m_checked.clear()
            logging.warning(
                "lattice vertex bucket overflow (%d vertices): that map's "
                "labels were set to Unknown; bucket grown to %d",
                overflow_max,
                self._m_bucket,
            )

    def flush(self) -> None:
        """Wait for every pending vertex count and handle its overflow.

        Without this, an overflow on the last map of a session is never seen:
        counts are drained only by a later map. Call at session end."""
        self._drain_overflow_flags(blocking=True)

    def __del__(self):  # pragma: no cover - interpreter-shutdown timing
        # Never wait on the device at teardown: a hang here cannot be
        # caught. Only warn that unread overflow probes exist.
        try:
            pending = getattr(self, "_pending_m", None)
            if pending:
                logging.warning(
                    "LocalMapPipeline deleted with %d unobserved overflow "
                    "probe(s); call flush() at session end to observe "
                    "lattice-bucket overflows on the final maps",
                    len(pending),
                )
        except Exception:
            pass  # logging may already be torn down

    def run_device(
        self, cloud_points, cloud_rgb, nodes: Sequence[MapNodeFrames]
    ) -> List[torch.Tensor]:
        """Fusion, smoothing and labels for one map, left on the device.

        With the device lattice, a map of an already checked cloud size runs
        :meth:`map_fused` without a synchronisation; the first map of a size
        adds one read of the vertex count, growing the bucket (and running
        again) while the count exceeds 80% of it.
        """
        # Drain before the gate: an overflow seen here clears the checked
        # sizes, and this map must then take the synchronising branch.
        self._drain_overflow_flags()
        dev = self.device
        points = torch.as_tensor(cloud_points, dtype=torch.float32, device=dev)
        if not self.crf.use_dense_crf:
            return self.label_map(self.fuse_unaries(points, nodes))
        if cloud_rgb is None:
            raise ValueError("dense CRF smoothing needs cloud RGB")
        rgb = torch.as_tensor(cloud_rgb, dtype=torch.float32, device=dev)
        labels, m = self.map_fused(points, rgb, nodes, self._m_bucket)
        if not self.use_device_lattice:
            return labels
        n = int(points.shape[0])
        if n not in self._m_checked:
            while int(m) > 0.8 * self._m_bucket:
                self._m_bucket *= 2
                labels, m = self.map_fused(points, rgb, nodes, self._m_bucket)
            self._m_checked.add(n)
        self._pending_m.append(_VertexCountProbe(self._m_bucket, m))
        return labels

    def run(
        self, cloud_points, cloud_rgb, nodes: Sequence[MapNodeFrames]
    ) -> List[np.ndarray]:
        """Fusion, smoothing and labels for one map, as per-layer uint8 arrays."""
        return [
            lbl.cpu().numpy().astype(np.uint8)
            for lbl in self.run_device(cloud_points, cloud_rgb, nodes)
        ]
