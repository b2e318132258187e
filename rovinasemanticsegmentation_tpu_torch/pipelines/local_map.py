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
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..fusion.projector import MultiProjector, project_winners
from ..models.crf import (
    potts_mean_field,
    potts_mean_field_multi_t,
    symmetric_norm,
)
from ..models.lattice import (
    attach_sorted_stream,
    build_lattice,
    build_lattice_device,
    lattice_tensors,
    pad_lattice,
)
from ..utils.profiling import counter, span

#: (node, camera) views that ``fuse_unaries`` projected the map into
fusion_views = counter("fusion.views")


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

    # [4, 4] keyframe transform, or its [C3, 3, 4] world -> camera pack
    # (``pipelines/streaming.py::pack_poses``)
    pose: np.ndarray
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


def _floor_labels(
    q_t: torch.Tensor,  # [C, N] one layer's marginals
    class_count: int,
    unknown_label: int,
    overflow: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Argmax with the 2/C confidence floor, Unknown below it
    (segmenter.cpp:645-657); ``overflow`` makes every label Unknown."""
    floor = torch.tensor(2.0 / class_count, dtype=torch.float32)
    lbl = torch.where(q_t.amax(dim=0) > floor, q_t.argmax(dim=0), unknown_label)
    if overflow is not None:
        lbl = torch.where(overflow, unknown_label, lbl)
    return lbl.to(torch.int32)


def _crf_labels(
    unaries: torch.Tensor,  # [N, C] accumulated log-posterior sums
    lattice: Sequence[torch.Tensor],  # the 8 tensors of build_lattice_device
    norm: torch.Tensor,  # [N] symmetric-normalisation vector
    weight: float,
    num_vertices: int,
    n_iterations: int,
    class_count: int,
    unknown_label: int,
) -> torch.Tensor:
    """One layer's int32 labels, points-major: the mean field on the energy
    ``-unaries`` (``setUnaryEnergy``, segmenter.cpp:642), then the 2/C
    floor."""
    q = potts_mean_field(-unaries, *lattice, norm, weight, num_vertices,
                         n_iterations)
    return _floor_labels(q.T, class_count, unknown_label)


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
    norm = symmetric_norm(lattice, num_vertices)
    q = potts_mean_field_multi_t(
        -unaries.T, *lattice, norm, weight, blocks, num_vertices, n_iterations
    )
    return [
        _floor_labels(ql, c, unk, overflow)
        for ql, c, unk in zip(torch.split(q, list(blocks)), blocks,
                              unknown_labels)
    ]


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
    """Fusion, dense-CRF smoothing and labelling of local maps on one device
    (with a ``mesh``, the mean field sharded over a world of ranks).

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
        mesh=None,
        mesh_axis: str = "model",
    ):
        """With a ``mesh`` (``parallel/mesh.py``; the pipeline then runs in
        every rank of its world, on ``mesh.device``) and the dense CRF on, the
        mean field runs point-sharded over ``mesh_axis``
        (:meth:`label_map_sharded`)."""
        self.projector = projector
        self.class_counts = [int(c) for c in class_counts]
        self.unknown_labels = [int(u) for u in unknown_labels]
        self.device = resolve_device(device)
        if mesh is not None and resolve_device(mesh.device) != self.device:
            raise ValueError(
                f"pipeline on {self.device}, mesh rank on {mesh.device}")
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.last_crf_variant: Optional[str] = None
        self.crf = crf
        self.use_device_lattice = bool(use_device_lattice)
        self._intrinsics = torch.from_numpy(projector.intrinsics).to(self.device)
        self._m_bucket = 1 << 14  # vertex slots of the device build
        self._m_checked = set()  # cloud sizes whose bucket was validated
        self._pending_m: List[_VertexCountProbe] = []
        # Maps whose vertex count was seen to overflow their bucket (each
        # labelled all Unknown on the device).
        self.overflow_maps = 0

    def _node_transforms(self, pose):
        """World -> camera (rotation [C3, 3, 3], translation [C3, 3]) on the
        device, from a 4x4 keyframe pose or a [C3, 3, 4] pack."""
        if tuple(np.shape(pose)) == (4, 4):
            rot, trans = self.projector.camera_transforms(np.asarray(pose))
            return (torch.from_numpy(rot).to(self.device),
                    torch.from_numpy(trans).to(self.device))
        pack = torch.as_tensor(pose, dtype=torch.float32, device=self.device)
        return pack[..., :3], pack[..., 3]

    def fuse_unaries(
        self, cloud_points, nodes: Sequence[MapNodeFrames]
    ) -> List[torch.Tensor]:
        """Per-layer [N, C_l] unary sums over the nodes (segmenter.cpp:561-626).

        Each node's cameras are projected together into the stacked image,
        their contributions summed and that sum added to the map's: nodes in
        order, cameras in order within a node. A node none of whose cameras
        has posteriors is not projected; each projected node adds its
        cameras to ``fusion.views``."""
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
            rot, trans = self._node_transforms(node.pose)
            fusion_views.add(ncam)
            won, flat = project_winners(
                points, rot, trans, self._intrinsics,
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
        with span("map.fusion"):
            fused = torch.cat(self.fuse_unaries(points, nodes), dim=1)
        feats = crf_feats(points, cloud_rgb, self.crf.xyz_kernel,
                          self.crf.rgb_kernel)
        if self.use_device_lattice:
            with span("map.lattice_build"):
                *lattice, m = build_lattice_device(feats, m_bucket)
            num_vertices, overflow = m_bucket, m > m_bucket
        else:
            host = attach_sorted_stream(
                pad_lattice(build_lattice(feats.cpu().numpy()))
            )
            lattice = lattice_tensors(host, self.device)
            num_vertices, m, overflow = host.num_vertices, None, None
        with span("map.mean_field"):
            labels = crf_labels_multi(
                fused, lattice, self.crf.kernel_weight, self.class_counts,
                num_vertices, self.crf.iterations, self.unknown_labels,
                overflow,
            )
        return labels, m

    def label_map_sharded(
        self, cloud_points, cloud_rgb, unaries: Sequence[torch.Tensor],
    ) -> List[torch.Tensor]:
        """Per-layer int32 labels with the mean field sharded over the mesh.

        The lattice is built on the host (the plan needs it there), the
        sharding planned over the axis, and the variant that moves fewer
        values per filter runs: the replicated ``[C, M+1]`` all_reduce or the
        vertex-sharded halo exchange (``parallel/sharded_lattice.py``). It
        is recorded in ``last_crf_variant``. The energy is ``-unaries``
        (segmenter.cpp:642), the floor 2/C with the layer's Unknown.
        """
        from ..parallel.sharded_lattice import (
            auto_sharded_potts_mean_field,
            plan_sharded_lattice,
        )

        feats = crf_feats(
            torch.as_tensor(cloud_points, dtype=torch.float32),
            torch.as_tensor(cloud_rgb, dtype=torch.float32),
            self.crf.xyz_kernel, self.crf.rgb_kernel,
        )  # [N, 6] (segmenter.cpp:629-637), on the host
        lattice = build_lattice(feats.cpu().numpy())
        plan = plan_sharded_lattice(lattice, self.mesh.shape[self.mesh_axis])
        energies = -torch.cat(
            [torch.as_tensor(u, dtype=torch.float32, device=self.device)
             for u in unaries], dim=1)
        q, variant = auto_sharded_potts_mean_field(
            self.mesh, self.mesh_axis, energies, lattice,
            float(self.crf.kernel_weight), tuple(self.class_counts),
            int(self.crf.iterations), plan=plan,
        )
        self.last_crf_variant = variant
        logging.info(
            "sharded map CRF: variant=%s (halo %d vs all_reduce %d "
            "values/filter)", variant, plan.comms_per_filter,
            plan.replicated_comms_per_filter,
        )
        return [
            _floor_labels(ql, c, unk)
            for ql, c, unk in zip(torch.split(q.T, self.class_counts),
                                  self.class_counts, self.unknown_labels)
        ]

    def _drain_overflow_flags(self, blocking: bool = False) -> None:
        """Read the vertex counts of finished maps without blocking.

        A map that ran without a synchronisation and overflowed its bucket
        was labelled all Unknown on the device; here its count is seen, the
        bucket grows to at least 1.25x it, and the checked sizes are cleared
        so that the next map of each size synchronises again; each such map
        adds one to ``overflow_maps``. ``blocking=True`` waits for every
        pending count (:meth:`flush`).
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
                self.overflow_maps += 1
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

    def run_device_maps(
        self, maps: Sequence[Tuple[object, object, Sequence[MapNodeFrames]]]
    ) -> List[List[torch.Tensor]]:
        """Fusion, smoothing and labels for each ``(cloud_points, cloud_rgb,
        nodes)`` map in turn, left on the device.

        The finished maps' vertex counts are drained once, before the first
        map. With the device lattice, a map of an already checked cloud size
        then runs :meth:`map_fused` without a synchronisation; the first map
        of a size adds one read of the vertex count, growing the bucket (and
        running again) while the count exceeds 80% of it.
        """
        # Drain before the gate: an overflow seen here clears the checked
        # sizes, and the maps must then take the synchronising branch.
        self._drain_overflow_flags()
        return [self._map_on_device(*m) for m in maps]

    def _map_on_device(
        self, cloud_points, cloud_rgb, nodes: Sequence[MapNodeFrames]
    ) -> List[torch.Tensor]:
        dev = self.device
        points = torch.as_tensor(cloud_points, dtype=torch.float32, device=dev)
        if not self.crf.use_dense_crf:
            with span("map.fusion"):
                unaries = self.fuse_unaries(points, nodes)
            return self.label_map(unaries)
        if cloud_rgb is None:
            raise ValueError("dense CRF smoothing needs cloud RGB")
        rgb = torch.as_tensor(cloud_rgb, dtype=torch.float32, device=dev)
        if self.mesh is not None:
            with span("map.fusion"):
                unaries = self.fuse_unaries(points, nodes)
            return self.label_map_sharded(points, rgb, unaries)
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

    def run_device(
        self, cloud_points, cloud_rgb, nodes: Sequence[MapNodeFrames]
    ) -> List[torch.Tensor]:
        """Fusion, smoothing and labels for one map, left on the device
        (:meth:`run_device_maps` on that map)."""
        return self.run_device_maps([(cloud_points, cloud_rgb, nodes)])[0]

    def run(
        self, cloud_points, cloud_rgb, nodes: Sequence[MapNodeFrames]
    ) -> List[np.ndarray]:
        """Fusion, smoothing and labels for one map, as per-layer uint8 arrays."""
        labels = self.run_device(cloud_points, cloud_rgb, nodes)
        with span("map.to_host"):
            return [lbl.cpu().numpy().astype(np.uint8) for lbl in labels]
