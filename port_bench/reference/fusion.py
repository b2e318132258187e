"""Map fusion, plainly: project a local map into its keyframes and sum the
winning pixels' frame posteriors into per-point unaries.

After the reference node's map worker (``segmenter.cpp:561-626``) and
fps_mapper's ``MultiProjector::project``: each point is taken into the
camera of a keyframe (``pose^-1``, then the camera's extrinsic inverse),
projected with the intrinsics to the pixel ``(int(u / z), int(v / z))``,
kept if its depth lies in the projector's range and the pixel in the image,
and per pixel the nearest point wins, ties to the lowest point index. The
winners add their pixel's posteriors (all layers side by side) to their
unaries. Without the dense CRF, labels are the argmax per layer with a
-1000 floor, and points no keyframe saw get the layer's Unknown label
(``segmenter.cpp:659-682``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def world_to_camera(pose: np.ndarray, cam_rot: np.ndarray,
                    cam_trans: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(rotation [3, 3], translation [3]) float32 taking world points into
    the camera of a keyframe ``pose`` (base -> world, 4x4) whose camera
    sits at ``(cam_rot, cam_trans)`` in the base."""
    pose = np.asarray(pose, np.float64)
    r_inv = np.asarray(cam_rot, np.float64).T
    t_inv = -r_inv @ np.asarray(cam_trans, np.float64)
    rp = pose[:3, :3].T
    tp = -rp @ pose[:3, 3]
    return (r_inv @ rp).astype(np.float32), (r_inv @ tp + t_inv).astype(np.float32)


def _apply(m: torch.Tensor, v: List[torch.Tensor]) -> List[torch.Tensor]:
    """``m`` [3, 3] times the float32 vectors ``v`` as a chain of fused
    multiply-adds, ``fma(v2, m2, fma(v1, m1, v0 m0))``, each step rounded
    once to float32 (the float64 product of two float32 numbers is exact).
    Map points backprojected from pixel centres land on integer pixel
    coordinates, where the truncation to a pixel depends on that last
    rounding."""
    out = []
    for r in range(3):
        acc = v[0] * m[r, 0]
        for j in (1, 2):
            acc = (v[j].double() * m[r, j].double() + acc.double()).float()
        out.append(acc)
    return out


def winners(points: torch.Tensor, rot, trans, intrinsic, d_min: float,
            d_max: float, h: int, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (indices of the points that won their pixel, their flat pixels)."""
    dev = points.device
    rot = torch.as_tensor(rot, dtype=torch.float32, device=dev)
    trans = torch.as_tensor(trans, dtype=torch.float32, device=dev)
    k = torch.as_tensor(intrinsic, dtype=torch.float32, device=dev)
    cam = [c + trans[i] for i, c in enumerate(_apply(rot, list(points.T)))]
    u, v, z = _apply(k, cam)
    safe = torch.where(z > 0, z, torch.ones_like(z))
    px = (u / safe).to(torch.int32).to(torch.int64)
    py = (v / safe).to(torch.int32).to(torch.int64)
    valid = (z >= d_min) & (z <= d_max) & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    idx = torch.nonzero(valid).reshape(-1).cpu().numpy()
    pix = (py * w + px)[valid].cpu().numpy()
    depth = z[valid].cpu().numpy()
    order = np.lexsort((idx, depth, pix))  # by pixel, then depth, then index
    first = np.ones(len(order), bool)
    first[1:] = pix[order][1:] != pix[order][:-1]
    won = order[first]
    return (torch.from_numpy(idx[won]).to(dev), torch.from_numpy(pix[won]).to(dev))


def unaries(points: torch.Tensor, nodes, intrinsic, cam_rot, cam_trans,
            d_min: float, d_max: float, h: int, w: int,
            dtype=torch.float32) -> torch.Tensor:
    """[N, sum(C_l)] unaries in ``dtype``: over ``nodes``, each a (pose 4x4,
    per-layer full-resolution posteriors [H, W, C_l]) pair, the winners'
    posteriors added in node order."""
    total = None
    for pose, posts in nodes:
        rot, trans = world_to_camera(pose, cam_rot, cam_trans)
        post = torch.cat([p.to(dtype) for p in posts], dim=-1).reshape(h * w, -1)
        if total is None:
            total = torch.zeros((points.shape[0], post.shape[1]), dtype=dtype,
                                device=points.device)
        idx, pix = winners(points, rot, trans, intrinsic, d_min, d_max, h, w)
        add = torch.zeros_like(total)
        add[idx] = post[pix]
        total = total + add
    return total


def plain_labels(unary: torch.Tensor, class_counts: Sequence[int],
                 unknown_labels: Sequence[int]) -> List[torch.Tensor]:
    """Per layer: argmax with a -1000 floor, Unknown where every unary of the
    layer is 0 (no keyframe saw the point)."""
    out, start = [], 0
    for c, unknown in zip(class_counts, unknown_labels):
        u = unary[:, start:start + c]
        start += c
        lbl = torch.argmax(u, dim=1)
        lbl = torch.where(u.amax(dim=1) > -1000.0, lbl, torch.full_like(lbl, unknown))
        lbl = torch.where(u.sum(dim=1) == 0, torch.full_like(lbl, unknown), lbl)
        out.append(lbl.to(torch.int32))
    return out
