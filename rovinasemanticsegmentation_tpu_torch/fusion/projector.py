"""Z-buffered projection of map point clouds into keyframe camera images.

Counterpart of ``rovinasemanticsegmentation_tpu/fusion/projector.py``
(``_project_pixels``, ``project_zbuffer``, ``project_winners``,
``MultiProjector``), the
equivalent of fps_mapper's ``MultiProjector::project`` at
``segmenter.cpp:578``: each map point lands on one pixel of each camera of
the vertically stacked multi-camera image, and per pixel the nearest point
wins, ties going to the lowest point index.

The winner is resolved with two order-independent ``scatter_reduce("amin")``
passes (depth, then point index among the points at that depth), so the
result does not depend on the order in which a GPU applies the updates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from ..utils.calibration import Calibration

_BIG = 3.0e38


def _apply_3x3(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``m [C, 3, 3]`` applied to ``v [C or 1, N, 3]`` -> [C, N, 3].

    Each output is the fused multiply-add chain that XLA's CPU dot emits
    for one camera (``x0 m0``, then ``+ x1 m1`` and ``+ x2 m2`` each
    rounded once: the float64 product of two float32 numbers is exact), so
    pixels and depths equal the JAX package's; no TF32 path.
    """
    vd = v.double()[..., None, :]  # [C or 1, N, 1, 3]
    md = m.double()[:, None]  # [C, 1, 3, 3]
    acc = v[..., None, 0] * m[:, None, :, 0]  # [C, N, 3]
    acc = (vd[..., 1] * md[..., 1] + acc.double()).float()
    return (vd[..., 2] * md[..., 2] + acc.double()).float()


def project_pixels(
    points: torch.Tensor,  # [N, 3] world points
    rotation_inv: torch.Tensor,  # [C3, 3, 3] world -> camera
    translation_inv: torch.Tensor,  # [C3, 3]
    intrinsics: torch.Tensor,  # [C3, 3, 3]
    min_distance: float,
    max_distance: float,
    height: int,
    width: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (flat pixel id [C3*N] int64, camera depth [C3*N] float32).

    Invalid (camera, point) pairs get the one-past-the-end pixel ``C3*H*W``
    and depth ``_BIG``. ``int()`` truncation and the validity rule are
    ``segmenter.cpp:578-588``'s.
    """
    ncam = rotation_inv.shape[0]
    npix = ncam * height * width
    cam = _apply_3x3(rotation_inv, points[None]) + translation_inv[:, None, :]
    z = cam[..., 2]
    uvw = _apply_3x3(intrinsics, cam)
    safe_z = torch.where(z > 0, z, torch.ones_like(z))
    px = (uvw[..., 0] / safe_z).to(torch.int32).to(torch.int64)
    py = (uvw[..., 1] / safe_z).to(torch.int32).to(torch.int64)
    valid = (
        (z >= min_distance)
        & (z <= max_distance)
        & (px >= 0)
        & (px < width)
        & (py >= 0)
        & (py < height)
    )
    # Cameras stack vertically (projector image = C3*H x W, segmenter.cpp:237).
    rows = py + torch.arange(ncam, device=points.device)[:, None] * height
    flat = torch.where(valid, rows * width + px, torch.full_like(px, npix))
    zf = torch.where(valid, z, torch.full_like(z, _BIG))
    return flat.reshape(-1), zf.reshape(-1)


def _zbuffer(
    flat: torch.Tensor, zf: torch.Tensor, keys: torch.Tensor, npix: int,
    absent: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two ``amin`` passes -> (zbuf [npix+1], owner [npix+1]).

    ``zbuf`` holds each pixel's least depth; ``owner`` the least ``key``
    among the pixel's points at that depth, ``absent`` where none. Slot
    ``npix`` collects the invalid pairs and is cut off by the callers.
    """
    dev = flat.device
    zbuf = torch.full((npix + 1,), _BIG, dtype=torch.float32, device=dev)
    zbuf = zbuf.scatter_reduce(0, flat, zf, reduce="amin")
    nearest = zbuf[flat] == zf
    owner = torch.full((npix + 1,), absent, dtype=torch.int64, device=dev)
    owner = owner.scatter_reduce(
        0, torch.where(nearest, flat, torch.full_like(flat, npix)), keys,
        reduce="amin",
    )
    return zbuf, owner


def project_zbuffer(
    points, rotation_inv, translation_inv, intrinsics, min_distance,
    max_distance, height: int, width: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (zbuffer [C3*H, W] float32, inf where empty; index image
    [C3*H, W] int32, the winning point per pixel or -1)."""
    ncam = rotation_inv.shape[0]
    n = points.shape[0]
    npix = ncam * height * width
    flat, zf = project_pixels(
        points, rotation_inv, translation_inv, intrinsics,
        min_distance, max_distance, height, width,
    )
    ids = torch.arange(n, device=points.device).repeat(ncam)
    zbuf, owner = _zbuffer(flat, zf, ids, npix, n)
    index_image = owner[:-1].reshape(ncam * height, width)
    index_image = torch.where(index_image == n, -1, index_image).to(torch.int32)
    zbuffer = zbuf[:-1].reshape(ncam * height, width)
    zbuffer = torch.where(index_image < 0, torch.inf, zbuffer)
    return zbuffer, index_image


def project_winners(
    points, rotation_inv, translation_inv, intrinsics, min_distance,
    max_distance, height: int, width: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (won [C3*N] bool, flat [C3*N] int64).

    ``won`` marks the (camera, point) pairs that are their pixel's z-buffer
    winner: least depth, ties to the lowest point index. Within one camera
    block slot order is point order, and camera blocks never share a pixel,
    so the slot id is the tie-break key.
    """
    flat, zf = project_pixels(
        points, rotation_inv, translation_inv, intrinsics,
        min_distance, max_distance, height, width,
    )
    npix = rotation_inv.shape[0] * height * width
    slot = torch.arange(flat.shape[0], device=points.device)
    _, owner = _zbuffer(flat, zf, slot, npix, flat.shape[0])
    won = (owner[flat] == slot) & (flat < npix)
    return won, flat


@dataclass
class MultiProjector:
    """Per-camera calibrations -> stacked-image projection."""

    rotations_inv: np.ndarray  # [C3, 3, 3]
    translations_inv: np.ndarray  # [C3, 3]
    intrinsics: np.ndarray  # [C3, 3, 3]
    height: int
    width: int
    min_distance: float = 0.0
    max_distance: float = 1.0e9

    @classmethod
    def from_calibrations(
        cls,
        calibrations: Sequence[Calibration],
        height: int,
        width: int,
        min_distance: float = 0.0,
        max_distance: float = 1.0e9,
    ) -> "MultiProjector":
        rot_inv, t_inv, ks = [], [], []
        for c in calibrations:
            r = c.rotation.T  # inverse of the camera->base extrinsic
            rot_inv.append(r)
            t_inv.append(-r @ c.translation)
            ks.append(c.intrinsic)
        return cls(
            rotations_inv=np.stack(rot_inv).astype(np.float32),
            translations_inv=np.stack(t_inv).astype(np.float32),
            intrinsics=np.stack(ks).astype(np.float32),
            height=int(height),
            width=int(width),
            min_distance=float(min_distance),
            max_distance=float(max_distance),
        )

    def camera_transforms(self, pose: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """World -> camera (rotation [C3, 3, 3], translation [C3, 3]) for a
        keyframe ``pose`` (4x4, base -> world), as the reference's
        ``projector.project(zbuf, idx, pose.inverse(), cloud)``
        (segmenter.cpp:578) composes them."""
        pose = np.asarray(pose, dtype=np.float32)
        rp = pose[:3, :3].T
        tp = -rp @ pose[:3, 3]
        rot = self.rotations_inv @ rp[None]
        trans = (
            np.einsum("cij,j->ci", self.rotations_inv, tp) + self.translations_inv
        )
        return rot.astype(np.float32), trans.astype(np.float32)

    def project(self, points, pose: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """(zbuffer, index image) of the cloud seen from keyframe ``pose``
        (:func:`project_zbuffer`), on the device of ``points`` (a tensor, or
        a host array for the CPU)."""
        points = torch.as_tensor(points, dtype=torch.float32)
        dev = points.device
        rot, trans = self.camera_transforms(pose)
        return project_zbuffer(
            points, torch.from_numpy(rot).to(dev),
            torch.from_numpy(trans).to(dev),
            torch.from_numpy(self.intrinsics).to(dev),
            self.min_distance, self.max_distance, self.height, self.width,
        )
