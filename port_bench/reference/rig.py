"""A map of a multi-camera rig, plainly: every node's frames from every
camera, fused into the map's unaries and labelled.

After the reference node's map worker (``segmenter.cpp:561-626``), whose
``MultiProjector::project`` (fps_mapper) projects the map into the image of
every camera of a keyframe node, each camera under its own extrinsic, and
adds the winning pixels' posteriors to the points' unaries. A camera's
winners are ``fusion.py::winners`` under that camera's world-to-camera
transform: the z-buffer of each camera's block of the stacked image is its
own.

**The transform in float32.** The node composes a camera's transform in
float32 (Eigen's ``Isometry3f``: the camera's inverse extrinsic times the
keyframe's inverse pose), and so does :func:`world_to_camera` here, where
``fusion.py::world_to_camera`` composes in float64 and rounds once. With a
rotated camera the two differ in the last bit, and a map point
backprojected from a pixel centre lands on an integer pixel coordinate,
whose truncation to a pixel that last bit decides. With the identity
extrinsic of a one-camera cell both give the same transform.

**The order of the sums.** The unaries sum nodes in order, and within a
node its cameras in order. The port (``pipelines/local_map.py``,
``fuse_unaries``: ``fused + contrib.reshape(ncam, n, ctot).sum(dim=0)``)
adds a node's cameras together first and that sum to the map's total, and
so does this reference; the source adds each camera's pixels to the unaries
in turn (``segmenter.cpp:589-616``, the stacked image's camera blocks in
order). The two agree bit for bit except at a point that two cameras of one
node both see (the rig's seams), where the last bit may differ. A camera
whose frame has no posteriors adds nothing (``segmenter.cpp:618-621``).

Labels: ``fusion.py::plain_labels``, or with ``use_dense_crf``
``lattice.py::crf_labels``. Plain PyTorch and NumPy in float32, with TF32
off while they run (their products are elementwise, so it could only come
in by a later edit); it imports nothing of the port.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from port_bench.reference import fusion, lattice


@contextlib.contextmanager
def no_tf32():
    """TF32 off for matrix products and convolutions, then as it was."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def extrinsics(conf: dict) -> List[Tuple[str, np.ndarray, np.ndarray]]:
    """Per camera of the configuration's ``rig``, in order: (name,
    camera-to-base rotation [3, 3] float32, translation [3] float32). The
    rotation is the yaw about the base's z axis (up; the axis whose
    coordinate the height feature reads) after ``optical_to_base``, which
    takes the camera's optical frame into the base's."""
    mount = np.asarray(conf["optical_to_base"], np.float64)
    out = []
    for cam in conf["rig"]:
        a = math.radians(float(cam["yaw_deg"]))
        yaw = np.array([[math.cos(a), -math.sin(a), 0.0],
                        [math.sin(a), math.cos(a), 0.0],
                        [0.0, 0.0, 1.0]])
        out.append((cam["name"], (yaw @ mount).astype(np.float32),
                    np.asarray(cam["translation_m"], np.float32)))
    return out


def world_to_camera(pose: np.ndarray, cam_rot: np.ndarray,
                    cam_trans: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(rotation [3, 3], translation [3]) taking world points into the
    camera of a keyframe ``pose`` (base -> world, 4x4) whose camera sits at
    ``(cam_rot, cam_trans)`` in the base, composed in float32."""
    r_inv = np.asarray(cam_rot, np.float32).T
    t_inv = -r_inv @ np.asarray(cam_trans, np.float32)
    pose = np.asarray(pose, np.float32)
    rp = pose[:3, :3].T
    tp = -rp @ pose[:3, 3]
    return r_inv @ rp, r_inv @ tp + t_inv


def unaries(points: torch.Tensor, nodes, intrinsic,
            rig: Sequence[Tuple[np.ndarray, np.ndarray]], d_min: float,
            d_max: float, h: int, w: int, dtype=torch.float32) -> torch.Tensor:
    """[N, sum(C_l)] unaries in ``dtype``: over ``nodes``, each a (pose 4x4,
    per camera of ``rig`` the per-layer full-resolution posteriors [H, W,
    C_l] or None) pair, with ``rig`` the cameras' (rotation, translation) in
    the base; the winners' posteriors summed per node over its cameras, and
    the nodes' sums added in order."""
    with no_tf32():
        return _unaries(points, nodes, intrinsic, rig, d_min, d_max, h, w, dtype)


def _unaries(points, nodes, intrinsic, rig, d_min, d_max, h, w, dtype):
    total: Optional[torch.Tensor] = None
    for pose, cams in nodes:
        node = None
        for (cam_rot, cam_trans), posts in zip(rig, cams, strict=True):
            if posts is None:
                continue
            rot, trans = world_to_camera(pose, cam_rot, cam_trans)
            post = torch.cat([p.to(dtype) for p in posts], dim=-1).reshape(h * w, -1)
            add = torch.zeros((points.shape[0], post.shape[1]), dtype=dtype,
                              device=points.device)
            idx, pix = fusion.winners(points, rot, trans, intrinsic, d_min, d_max, h, w)
            add[idx] = post[pix]
            node = add if node is None else node + add
        if node is not None:
            total = (torch.zeros_like(node) if total is None else total) + node
    if total is None:
        raise ValueError("no camera of any node has posteriors")
    return total


def labels(unary: torch.Tensor, points: torch.Tensor, colors: torch.Tensor,
           conf: dict, class_counts: Sequence[int],
           unknown_labels: Sequence[int]) -> List[torch.Tensor]:
    """Per-layer int32 labels of a map's unaries, as the configuration asks."""
    with no_tf32():
        if conf["use_dense_crf"]:
            return lattice.crf_labels(unary, points, colors, conf, class_counts,
                                      unknown_labels)
        return fusion.plain_labels(unary, class_counts, unknown_labels)
