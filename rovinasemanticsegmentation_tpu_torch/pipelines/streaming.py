"""The streaming step: a keyframe batch and the local maps it feeds.

Counterpart of ``rovinasemanticsegmentation_tpu/pipelines/streaming.py``,
the throughput path (batch and offline serving). One call runs the frame
batch, whole keyframe nodes of every camera of the rig (features -> forest
descent -> posteriors -> labels: kernels A and B on a GPU), and then every
local map of that batch (fusion of each node's cameras -> device lattice
build -> fused multi-layer CRF -> labels, or the fused unaries' own labels
with the dense CRF off), with each map's keyframe posteriors handed over in
device memory. The JAX package fused both into one jitted graph to save TPU
dispatches, for one camera a node and the dense CRF; here the
step is the two pipelines' own calls in a row, issued without a host
synchronisation.

The reference runs a frame worker and a map worker in two threads
(``segmenter.cpp:227-232``); the online node (``serve/segmenter.py``) keeps
that design for its per-keyframe latency.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..utils.profiling import counter, span
from .local_map import LocalMapPipeline, MapNodeFrames
from .single_frame import SingleFramePipeline

#: frames that ``StreamingPipeline.run_staged`` took, a call adding its batch
streaming_frames = counter("streaming.frames")


def pack_poses(projector, poses: Sequence[np.ndarray]) -> np.ndarray:
    """[K, C3, 3, 4] world -> camera ``rot_inv | t_inv`` packs of keyframe
    ``poses`` (segmenter.cpp:561-571), the math of
    ``MultiProjector.camera_transforms``."""
    rot_all, t_all = [], []
    for pose in poses:
        pose = np.asarray(pose, np.float32)
        rp = pose[:3, :3].T
        tp = -rp @ pose[:3, 3]
        rot_all.append(projector.rotations_inv @ rp[None])
        t_all.append(
            np.einsum("cij,j->ci", projector.rotations_inv, tp)
            + projector.translations_inv
        )
    return np.concatenate(
        [np.stack(rot_all), np.stack(t_all)[..., None]], axis=-1
    ).astype(np.float32)


class StreamingPipeline:
    """Drive a frame batch and its maps with the two pipelines' configs.

    A batch's maps run through ``LocalMapPipeline.run_device_maps``, which
    owns the vertex bucket: the first map of a cloud size reads its vertex
    count once, later maps of that size run without a synchronisation, and
    an overflowing map is labelled all Unknown on the device while the
    bucket grows for the following maps.
    """

    def __init__(
        self,
        frame_pipeline: SingleFramePipeline,
        map_pipeline: LocalMapPipeline,
        map_every: int,
    ):
        if map_pipeline.crf.use_dense_crf and not map_pipeline.use_device_lattice:
            raise ValueError("streaming builds the lattice on the device")
        if frame_pipeline.device != map_pipeline.device:
            raise ValueError(
                f"frame pipeline on {frame_pipeline.device}, map pipeline on "
                f"{map_pipeline.device}"
            )
        self.frames = frame_pipeline
        self.maps = map_pipeline
        self.map_every = int(map_every)

    def run_staged(
        self,
        rgb_stack,  # [B, H, W, 3] (device-resident preferred)
        depth_stack,  # [B, H, W]
        kinv, rot, trans,  # [B, 3, 3] x2, [B, 3]
        clouds,  # [Mb, N, 3] with Mb = (B // C3) // map_every
        cloud_rgb,  # [N, 3] or [Mb, N, 3]
        pose_packed,  # [Mb, K, C3, 3, 4] (see :func:`pack_poses`)
    ) -> Tuple[List[List[torch.Tensor]], List[List[torch.Tensor]]]:
        """Returns (frame labels per frame per layer, map labels per map per
        layer), all on the device and not synchronised.

        The batch is whole keyframe nodes of the map pipeline's ``C3``
        cameras: ``B = nodes * C3`` frames, node-major and camera-minor
        (frame ``n * C3 + c`` is camera ``c`` of node ``n``), each with its
        own camera's ``kinv``/``rot``/``trans``. All frames run in one
        ``run_batch_stacked`` call (one descent); map ``m`` fuses nodes
        ``m * map_every`` .. ``(m + 1) * map_every - 1`` with every camera's
        posteriors. With tracing on, the call is a ``stream.step`` span
        (``attrs``: nodes, cameras); ``streaming.frames`` adds ``B``."""
        fp, mp = self.frames, self.maps
        dev = mp.device
        b = int(rgb_stack.shape[0])
        cams = int(mp.projector.intrinsics.shape[0])
        if b % cams:
            raise ValueError(
                f"{b} frames are not whole nodes of {cams} cameras"
            )
        nodes = b // cams
        maps_per_batch = nodes // self.map_every
        if maps_per_batch != int(clouds.shape[0]):
            raise ValueError(
                f"{int(clouds.shape[0])} clouds for {maps_per_batch} maps"
            )
        with span("stream.step", attrs={"nodes": nodes, "cameras": cams}):
            streaming_frames.add(b)
            results = fp.run_batch_stacked(rgb_stack, depth_stack, kinv, rot,
                                           trans)
            clouds = torch.as_tensor(clouds, dtype=torch.float32, device=dev)
            cloud_rgb = torch.as_tensor(cloud_rgb, dtype=torch.float32,
                                        device=dev)
            pose_packed = torch.as_tensor(pose_packed, dtype=torch.float32,
                                          device=dev)
            # Each node's posteriors are its cameras' frames', still on the
            # device.
            k = self.map_every
            maps = [
                (clouds[m], cloud_rgb[m] if cloud_rgb.ndim == 3 else cloud_rgb,
                 [MapNodeFrames(
                     pose=pose_packed[m, j],
                     posteriors=[results[(m * k + j) * cams + c].posteriors
                                 for c in range(cams)])
                  for j in range(k)])
                for m in range(maps_per_batch)
            ]
            return [r.labels for r in results], mp.run_device_maps(maps)
