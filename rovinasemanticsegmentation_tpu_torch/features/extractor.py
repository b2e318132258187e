"""Per-keyframe feature extraction on the stride grid.

Counterpart of ``rovinasemanticsegmentation_tpu/features/extractor.py``
(``FeatureConfig``, ``_extract_impl``, ``FeatureExtractor``), after
``Features::FeatureExtractor::extract`` (``feature_extractor.h:25-392``):
every grid point is computed and a boolean ``mask`` carries validity (depth
inside ``[d_min, d_max]`` in millimetres). The feature layout matches
``feature_extractor.h:47-51``: ``[R*R*3 Lab patch | depth | height | normal
angle]`` with the same config gating.

The colour patches go through ``ops/patches_cuda.py``: the CUDA kernel on a
CUDA device at any stride, its plain version on the CPU.
:func:`extract_features` returns float32 rows; the frame path calls
:func:`extract_feature_rows`, which writes the same features as packed 8-bit
rows (``ops/feature_rows.py``) into the batch's row buffer.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.color import rgb_to_lab8
from ..ops.geometry import (
    backproject,
    depth_valid_mask,
    millimetres_to_metres,
)
from ..ops.feature_rows import RowLayout, check_rows, tail_view
from ..ops.normals import normal_angles_grid
from ..ops.patches import reflect_pad_image
from ..ops.patches_cuda import extract_patches, extract_patches_into
from ..utils.calibration import Calibration
from ..utils.config import Config


class ExtractType(enum.Enum):
    WITH_ANY_LABEL = 0
    WITH_POSITIVE_LABEL = 1
    NO_LABEL = 2


@dataclass(frozen=True)
class FeatureConfig:
    """Static feature-extraction parameters (resources/config.json:31-44)."""

    patch_size: int = 77
    patch_size_reduce: int = 11
    use_color_patch: bool = True
    use_depth: bool = True
    use_height: bool = True
    use_normal: bool = True
    d_min: float = 0.5
    d_max: float = 15.0

    @classmethod
    def from_config(cls, conf: Config) -> "FeatureConfig":
        return cls(
            patch_size=conf.get_int("patch_size"),
            patch_size_reduce=conf.get_int("patch_size_reduce"),
            use_color_patch=conf.get_bool("feature_color_patch"),
            use_depth=conf.get_bool("feature_depth"),
            use_height=conf.get_bool("feature_height"),
            use_normal=conf.get_bool("feature_normal"),
            d_min=conf.get_float("depth_min"),
            d_max=conf.get_float("depth_max"),
        )


@dataclass
class FeatureBatch:
    """Dense stride-grid features for one frame.

    ``features[p]`` is meaningful only where ``mask[p]``; masked rows are
    zeroed. ``xs``/``ys`` give each grid point's full-resolution pixel.
    """

    features: torch.Tensor  # [P, D] float32
    mask: torch.Tensor  # [P] bool
    xs: np.ndarray  # [P] int64
    ys: np.ndarray  # [P] int64
    grid_shape: Tuple[int, int]
    labels: Optional[torch.Tensor] = None  # [P, L] int8 when extracted


def _grid_depth(depth_f: torch.Tensor, config: FeatureConfig, stride: int):
    """(validity mask, depth in metres) on the stride grid."""
    depth_grid_mm = depth_f[::stride, ::stride]
    mask = depth_valid_mask(depth_grid_mm, config.d_min, config.d_max)
    return mask, millimetres_to_metres(depth_grid_mm)


def patch_inputs(
    rgb: torch.Tensor, depth_mm: torch.Tensor, config: FeatureConfig,
    stride: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The patch kernel's inputs: (reflect-padded 8-bit Lab [H+2B, W+2B, 3],
    grid depth in metres [gh, gw], 0 where invalid)."""
    lab = rgb_to_lab8(rgb)  # BGR2Lab-on-RGB quirk preserved
    padded = reflect_pad_image(lab, config.patch_size)
    mask, depth_m = _grid_depth(depth_mm.to(torch.float32), config, stride)
    return padded, torch.where(mask, depth_m, torch.zeros_like(depth_m))


def feature_row_layout(config: FeatureConfig) -> RowLayout:
    """The packed row of ``config``'s features (``ops/feature_rows.py``)."""
    r = config.patch_size_reduce
    return RowLayout.packed(
        3 * r * r if config.use_color_patch else 0,
        int(config.use_depth) + int(config.use_height) + int(config.use_normal),
    )


def _tail_features(
    depth_f, depth_m, intrinsic_inverse, rotation, translation,
    config: FeatureConfig, s: int,
) -> List[torch.Tensor]:
    """Depth, height and normal angle, each [P, 1] float32, as enabled."""
    parts = []
    if config.use_depth:
        parts.append(depth_m.reshape(-1, 1))
    if config.use_height or config.use_normal:
        points = backproject(
            depth_f, intrinsic_inverse, rotation, translation,
            config.d_min, config.d_max,
        )
        if config.use_height:
            height = points[::s, ::s, 2].reshape(-1, 1)
            parts.append(torch.nan_to_num(height))
        if config.use_normal:
            parts.append(normal_angles_grid(points, s).reshape(-1, 1))
    return parts


def extract_features(
    rgb: torch.Tensor,  # [H, W, 3] uint8 (RGB order)
    depth_mm: torch.Tensor,  # [H, W] depth in millimetres
    intrinsic_inverse: torch.Tensor,  # [3, 3]
    rotation: torch.Tensor,  # [3, 3]
    translation: torch.Tensor,  # [3]
    config: FeatureConfig,
    stride: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (features [P, D] float32, mask [P] bool) on the inputs' device."""
    s = int(stride)
    depth_f = depth_mm.to(torch.float32)
    mask2d, depth_m = _grid_depth(depth_f, config, s)
    gh, gw = depth_m.shape

    parts = []
    if config.use_color_patch:
        padded, depth_grid = patch_inputs(rgb, depth_mm, config, s)
        patches = extract_patches(
            padded, depth_grid, config.patch_size, config.patch_size_reduce, s
        )
        r = config.patch_size_reduce
        parts.append(patches.reshape(gh * gw, r * r * 3).to(torch.float32))
    parts += _tail_features(depth_f, depth_m, intrinsic_inverse, rotation,
                            translation, config, s)

    mask = mask2d.reshape(-1)
    features = torch.cat(parts, dim=1)
    features = torch.where(mask[:, None], features, torch.zeros_like(features))
    return features, mask


def extract_feature_rows(
    rgb: torch.Tensor,  # [H, W, 3] uint8 (RGB order)
    depth_mm: torch.Tensor,  # [H, W] depth in millimetres
    intrinsic_inverse: torch.Tensor,  # [3, 3]
    rotation: torch.Tensor,  # [3, 3]
    translation: torch.Tensor,  # [3]
    config: FeatureConfig,
    stride: int,
    rows: torch.Tensor,  # [N, row_bytes] uint8, feature_row_layout(config)
    row0: int,
) -> torch.Tensor:
    """:func:`extract_features` written as packed rows ``[row0, row0 + P)``.

    Kernel A writes the patch bytes (and zeros to the end of each row); the
    float32 tail goes into a float32 view of the rows. Masked rows are all
    zero bytes. -> mask [P] bool. Unpacked (``unpack_rows``), the rows equal
    :func:`extract_features`' float rows bit for bit.
    """
    layout = feature_row_layout(config)
    check_rows(rows, layout)
    s = int(stride)
    depth_f = depth_mm.to(torch.float32)
    mask2d, depth_m = _grid_depth(depth_f, config, s)
    mask = mask2d.reshape(-1)
    block = rows[row0 : row0 + mask.shape[0]]
    if config.use_color_patch:
        padded, depth_grid = patch_inputs(rgb, depth_mm, config, s)
        extract_patches_into(
            padded, depth_grid, config.patch_size, config.patch_size_reduce, s,
            rows, row0,
        )
    tail = tail_view(block, layout)
    parts = _tail_features(depth_f, depth_m, intrinsic_inverse, rotation,
                           translation, config, s)
    k = len(parts)
    if k:
        values = torch.cat(parts, dim=1)  # [P, k], k <= 3
        tail[:, :k] = torch.where(mask[:, None], values,
                                  torch.zeros((), device=values.device))
    tail[:, k:] = 0
    return mask


class FeatureExtractor:
    """Config + extraction of one calibrated frame on a device."""

    def __init__(self, config: FeatureConfig, device: torch.device | str):
        self.config = config
        self.device = resolve_device(device)

    def extract(
        self,
        rgb: np.ndarray,
        depth_mm: np.ndarray,
        calibration: Calibration,
        stride: int,
        label_extraction: ExtractType = ExtractType.NO_LABEL,
        labels: Optional[Sequence[np.ndarray]] = None,
    ) -> FeatureBatch:
        dev = self.device
        features, mask = extract_features(
            to_device_image(rgb, dev),
            to_device_depth(depth_mm, dev),
            torch.from_numpy(np.asarray(calibration.intrinsic_inverse)).to(dev),
            torch.from_numpy(np.asarray(calibration.rotation)).to(dev),
            torch.from_numpy(np.asarray(calibration.translation)).to(dev),
            self.config,
            stride,
        )
        h, w = np.asarray(depth_mm).shape
        gys = np.arange(0, h, stride)
        gxs = np.arange(0, w, stride)
        ys = np.repeat(gys, gxs.size)
        xs = np.tile(gxs, gys.size)

        label_arr = None
        if label_extraction != ExtractType.NO_LABEL:
            if not labels:
                raise ValueError("labels required for labeled extraction")
            stacked = np.stack(
                [np.asarray(l)[ys, xs] for l in labels], axis=1
            ).astype(np.int8)
            label_arr = torch.from_numpy(stacked).to(dev)
            if label_extraction == ExtractType.WITH_POSITIVE_LABEL:
                # All layers must be labelled >= 0 (feature_extractor.h:99-103).
                mask = mask & torch.all(label_arr >= 0, dim=1)

        return FeatureBatch(
            features=features,
            mask=mask,
            xs=xs,
            ys=ys,
            grid_shape=(gys.size, gxs.size),
            labels=label_arr,
        )


def to_device_image(rgb, device: torch.device) -> torch.Tensor:
    """Host or device [H, W, 3] uint8 image -> uint8 tensor on ``device``."""
    if isinstance(rgb, torch.Tensor):
        return rgb.to(device=device, dtype=torch.uint8)
    return torch.from_numpy(np.ascontiguousarray(rgb, np.uint8)).to(device)


def to_device_depth(depth_mm, device: torch.device) -> torch.Tensor:
    """Host or device [H, W] depth (uint16 mm) -> int32 tensor on ``device``."""
    if isinstance(depth_mm, torch.Tensor):
        return depth_mm.to(device=device, dtype=torch.int32)
    return torch.from_numpy(np.asarray(depth_mm).astype(np.int32)).to(device)
