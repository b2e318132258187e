"""The frame path, plainly: RGB-D keyframe -> features -> forest -> labels.

After the reference node's per-keyframe worker (``segmenter.cpp:323-443``)
and ``feature_extractor.h``:

1. 8-bit Lab of the RGB-ordered image through OpenCV's fixed-point BGR2Lab
   (the reference's red/blue swap kept), reflect-padded by the patch size;
2. per stride-grid point with depth in ``[d_min, d_max]``: an ``R x R x 3``
   patch resampled from a ``(2h+1)``-pixel window, ``h = floor(B / 2d)``,
   with OpenCV's 8U bilinear rule; the depth in metres; the height (world
   z); the normal angle ``acos(|n_z|)`` of PCL's integral-image normals
   (AVERAGE_3D_GRADIENT, change factor 0.02, smoothing 10);
3. each tree's descent (``node <- left + (x[f] >= thr)`` to a leaf), the
   leaf log-histograms summed over the trees in order;
4. per layer, the stride posteriors (``fill`` where masked) resized
   bilinearly to full resolution (``cv::resize`` INTER_LINEAR), argmax with
   a -1000 floor (-1 where nothing beats it).

Everything is plain tensor code on the given device, one frame at a time;
the forest file is decoded here in Python.
"""

from __future__ import annotations

import functools
import struct
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

# ----------------------------------------------------------------------
# 8-bit Lab (OpenCV color_lab.cpp, 8U path)
# ----------------------------------------------------------------------

_LAB_SHIFT = 12
_GAMMA_SHIFT = 3
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT
_XYZ_FROM_RGB = np.array([
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
])
_D65 = np.array([0.950456, 1.0, 1.088754])


@functools.lru_cache(maxsize=None)
def _lab_tables():
    """OpenCV's initLabTabs() in float32: sRGB gamma table scaled by
    ``255 << 3``, cube-root table scaled by ``1 << 15``, 12-bit XYZ matrix
    with the white point folded in."""
    f255 = np.float32(255.0)
    i = (np.arange(256, dtype=np.float32) / f255).astype(np.float32)
    lo = (i / np.float32(12.92)).astype(np.float32)
    hi = np.power((i + np.float32(0.055)) / np.float32(1.055), np.float32(2.4),
                  dtype=np.float32)
    gamma = np.rint(np.float32(255 << _GAMMA_SHIFT)
                    * np.where(i <= np.float32(809.0 / 20000.0), lo, hi))
    n = (255 * 3 // 2 + 1) * (1 << _GAMMA_SHIFT)
    x = (np.arange(n, dtype=np.float32)
         / np.float32(255 << _GAMMA_SHIFT)).astype(np.float32)
    flo = (x * np.float32(7.787) + np.float32(16.0 / 116.0)).astype(np.float32)
    cbrt = np.rint(np.float32(1 << _LAB_SHIFT2)
                   * np.where(x < np.float32(0.008856), flo,
                              np.cbrt(x, dtype=np.float32)))
    coeffs = np.array([[np.rint((1 << _LAB_SHIFT) * np.float32(
        np.float32(_XYZ_FROM_RGB[r, c]) / np.float32(_D65[r])))
        for c in range(3)] for r in range(3)], np.int64)
    return gamma.astype(np.int64), cbrt.astype(np.int64), coeffs


def rgb_to_lab8(image: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] uint8, RGB order, -> uint8 Lab, as ``cv::cvtColor(..,
    CV_BGR2Lab)`` on it: channel 0 takes OpenCV's blue slot."""
    gamma_np, cbrt_np, c = _lab_tables()
    gamma = torch.from_numpy(gamma_np).to(image.device)
    cbrt = torch.from_numpy(cbrt_np).to(image.device)
    idx = image.to(torch.int64)
    b, g, r = gamma[idx[..., 0]], gamma[idx[..., 1]], gamma[idx[..., 2]]

    def descale(v, n):
        return (v + (1 << (n - 1))) >> n

    def f(row):
        return cbrt[descale(r * int(c[row, 0]) + g * int(c[row, 1])
                            + b * int(c[row, 2]), _LAB_SHIFT)]

    fx, fy, fz = f(0), f(1), f(2)
    l_scale = (116 * 255 + 50) // 100
    l_shift = -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)
    lab = torch.stack([
        descale(l_scale * fy + l_shift, _LAB_SHIFT2),
        descale(500 * (fx - fy) + (128 << _LAB_SHIFT2), _LAB_SHIFT2),
        descale(200 * (fy - fz) + (128 << _LAB_SHIFT2), _LAB_SHIFT2),
    ], dim=-1)
    return lab.clamp(0, 255).to(torch.uint8)


# ----------------------------------------------------------------------
# Depth-adaptive patches (feature_extractor.h:125-175)
# ----------------------------------------------------------------------


def reflect_pad(image: torch.Tensor, border: int) -> torch.Tensor:
    """``cv::copyMakeBorder`` BORDER_REFLECT (edge pixel repeated)."""
    def index(n):
        i = torch.arange(-border, n + border, device=image.device) % (2 * n)
        return torch.where(i < n, i, 2 * n - 1 - i)

    return image[index(image.shape[0])][:, index(image.shape[1])]


@functools.lru_cache(maxsize=None)
def tap_tables(patch: int, reduce: int):
    """Per window half-size ``h``: the ``R`` left/right taps (offsets from
    the grid pixel in padded coordinates) and their weights in 1/2048ths,
    OpenCV's INTER_LINEAR mapping ``src = (dst + 0.5) w / R - 0.5``."""
    t0, t1, w0, w1 = (np.zeros((patch + 1, reduce), np.int64) for _ in range(4))
    for h in range(patch + 1):
        w = 2 * h + 1
        for j in range(reduce):
            fx = (j + 0.5) * w / reduce - 0.5
            sx = int(np.floor(fx))
            frac = fx - sx
            if sx < 0:
                sx, frac = 0, 0.0
            if sx >= w - 1:
                sx, frac = w - 1, 0.0
            t0[h, j] = patch - h + sx
            t1[h, j] = patch - h + min(sx + 1, w - 1)
            w0[h, j] = int(round((1 - frac) * 2048))
            w1[h, j] = int(round(frac * 2048))
    return t0, t1, w0, w1


def patches(padded: torch.Tensor, depth_grid: torch.Tensor, patch: int,
            reduce: int, stride: int) -> torch.Tensor:
    """[gh, gw, R, R, 3] uint8 patches, zero where the depth is 0."""
    dev = padded.device
    gh, gw = depth_grid.shape
    wp = padded.shape[1]
    t0, t1, w0, w1 = (torch.from_numpy(a).to(dev)
                      for a in tap_tables(patch, reduce))
    safe = torch.clamp(depth_grid, min=1e-6)
    half = torch.floor(torch.full_like(safe, float(patch)) / (2.0 * safe))
    half = torch.clamp(half.to(torch.int64), max=patch)
    valid = depth_grid > 0
    hc = torch.where(valid, half, torch.zeros_like(half))
    gy = (torch.arange(gh, device=dev) * stride)[:, None, None]
    gx = (torch.arange(gw, device=dev) * stride)[None, :, None]
    flat = padded.reshape(-1, 3).to(torch.int64)

    def tap(rows, cols):
        return flat[rows[..., :, None] * wp + cols[..., None, :]]

    r0, r1 = gy + t0[hc], gy + t1[hc]
    c0, c1 = gx + t0[hc], gx + t1[hc]
    wx0, wx1 = w0[hc][..., None, :, None], w1[hc][..., None, :, None]
    wy0, wy1 = w0[hc][..., :, None, None], w1[hc][..., :, None, None]
    acc = ((tap(r0, c0) * wx0 + tap(r0, c1) * wx1) * wy0
           + (tap(r1, c0) * wx0 + tap(r1, c1) * wx1) * wy1)
    out = torch.clamp((acc + (1 << 21)) >> 22, 0, 255).to(torch.uint8)
    return torch.where(valid[..., None, None, None], out, torch.zeros_like(out))


# ----------------------------------------------------------------------
# Backprojection and normals (feature_extractor.h:200-284)
# ----------------------------------------------------------------------


def backproject(depth_mm: torch.Tensor, kinv, rot, trans, d_min: float,
                d_max: float) -> torch.Tensor:
    """[H, W] depth in mm -> [H, W, 3] float32 world points ``R K^-1 [dx,
    dy, d] + t``, NaN where the depth in metres is outside the range."""
    dev = depth_mm.device
    h, w = depth_mm.shape
    f32 = functools.partial(torch.as_tensor, dtype=torch.float32, device=dev)
    kinv, rot, trans = f32(kinv), f32(rot), f32(trans)
    d = depth_mm.to(torch.float32) * 0.001
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    m = [[rot[c, 0] * kinv[0, k] + rot[c, 1] * kinv[1, k] + rot[c, 2] * kinv[2, k]
          for k in range(3)] for c in range(3)]
    px, py = d * xs, d * ys
    world = torch.stack([px * m[c][0] + py * m[c][1] + d * m[c][2] + trans[c]
                         for c in range(3)], dim=-1)
    valid = (d >= f32(d_min)) & (d <= f32(d_max))
    return torch.where(valid[..., None], world, torch.full_like(world, float("nan")))


def _shift(a: torch.Tensor, dy: int, dx: int, fill: float) -> torch.Tensor:
    """``out[.., y, x] = a[.., y - dy, x - dx]``, ``fill`` outside."""
    h, w = a.shape[-2:]
    out = torch.full_like(a, fill)
    out[..., max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] = \
        a[..., max(-dy, 0):h + min(-dy, 0), max(-dx, 0):w + min(-dx, 0)]
    return out


def normal_angles_grid(points: torch.Tensor, stride: int,
                       change_factor: float = 0.02,
                       smoothing_size: float = 10.0) -> torch.Tensor:
    """PCL's integral-image normals at the stride-grid pixels: ``[gh, gw]``
    float32 ``acos(|n_z|)``, -2 where invalid.

    The change map marks right or lower neighbour pairs whose depth jumps by
    more than ``2 f (|z| + 1)`` or is missing; the smoothing window is the
    chamfer distance (1 axial, 1.4 diagonal) to the nearest change, capped
    at the smoothing size; the window sums of both central-difference
    gradients come from float64 integral images, and the normal is their
    cross product. Points within ``int(size)`` pixels of the border, or
    whose window is 2 pixels or less, are invalid.
    """
    dev = points.device
    h, w = points.shape[:2]
    z = points[..., 2]
    invalid = torch.isnan(z)
    nan = float("nan")
    thresh = change_factor * (torch.abs(z) + 1.0) * 2.0
    xs = torch.arange(w, device=dev)[None, :]
    ys = torch.arange(h, device=dev)[:, None]
    z_r, z_d = _shift(z, 0, -1, nan), _shift(z, -1, 0, nan)
    change_x = (xs < w - 1) & (invalid | torch.isnan(z_r) | (torch.abs(z - z_r) > thresh))
    change_y = (ys < h - 1) & (invalid | torch.isnan(z_d) | (torch.abs(z - z_d) > thresh))
    change = (change_x | change_y | _shift(change_x, 0, 1, False)
              | _shift(change_y, 1, 0, False))

    # Chamfer distance, saturated at the smoothing size: ceil(size) rounds of
    # 3x3 min-plus relaxation; the first and last columns keep their seed.
    sat = float(smoothing_size)
    seed = torch.where(change, torch.zeros((), device=dev),
                       torch.full((), sat, device=dev))
    edge = ((xs == 0) | (xs == w - 1))
    dist = seed
    for _ in range(int(np.ceil(sat))):
        axial = torch.stack([_shift(dist, dy, dx, sat) for dy, dx in
                             ((0, 1), (0, -1), (1, 0), (-1, 0))]).amin(0)
        diag = torch.stack([_shift(dist, dy, dx, sat) for dy, dx in
                            ((1, 1), (1, -1), (-1, 1), (-1, -1))]).amin(0)
        relaxed = torch.minimum(axial + 1.0, diag + 1.4)
        dist = torch.where(edge, seed, torch.minimum(dist, relaxed))

    # Float64 integral images of [grad_x (3), grad_y (3), valid_x, valid_y].
    p = points.permute(2, 0, 1).double()
    gx = _shift(p, 0, -1, nan) - _shift(p, 0, 1, nan)
    gy = _shift(p, -1, 0, nan) - _shift(p, 1, 0, nan)
    stack = torch.cat([torch.nan_to_num(gx), torch.nan_to_num(gy),
                       (~torch.isnan(gx[0]))[None].double(),
                       (~torch.isnan(gy[0]))[None].double()])
    integ = torch.zeros((8, h + 1, w + 1), dtype=torch.float64, device=dev)
    integ[:, 1:, 1:] = torch.cumsum(torch.cumsum(stack, dim=1), dim=2)

    s = int(stride)
    smoothing = torch.clamp(dist[::s, ::s], max=sat)
    rect = smoothing.to(torch.int64)
    gys = (torch.arange(0, h, s, device=dev))[:, None]
    gxs = (torch.arange(0, w, s, device=dev))[None, :]
    y0 = torch.clamp(gys - rect // 2, 0, h)
    y1 = torch.clamp(gys - rect // 2 + rect, 0, h)
    x0 = torch.clamp(gxs - rect // 2, 0, w)
    x1 = torch.clamp(gxs - rect // 2 + rect, 0, w)
    box = integ[:, y1, x1] - integ[:, y0, x1] - integ[:, y1, x0] + integ[:, y0, x0]
    a, b = box[3:6], box[0:3]  # normal = grad_y sum x grad_x sum
    normal = torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                          a[0] * b[1] - a[1] * b[0]])
    norm = torch.sqrt((normal * normal).sum(dim=0))
    border = int(smoothing_size)
    ok = ((smoothing > 2.0) & ~invalid[::s, ::s] & (box[6] > 0) & (box[7] > 0)
          & (norm > 0) & (gys >= border) & (gys < h - border)
          & (gxs >= border) & (gxs < w - border))
    nz = torch.abs(normal[2]) / torch.clamp(norm, min=1e-20)
    angle = torch.arccos(torch.clamp(nz, 0.0, 1.0)).float()
    return torch.where(ok, angle, torch.full_like(angle, -2.0))


# ----------------------------------------------------------------------
# Features
# ----------------------------------------------------------------------


@dataclass(frozen=True)
class FrameConfig:
    """The configuration's frame-path settings."""

    patch_size: int
    patch_size_reduce: int
    stride: int
    d_min: float
    d_max: float
    use_color_patch: bool = True
    use_depth: bool = True
    use_height: bool = True
    use_normal: bool = True

    @classmethod
    def from_config(cls, conf: dict) -> "FrameConfig":
        return cls(conf["patch_size"], conf["patch_size_reduce"],
                   conf["rf_prediction_stride"], conf["depth_min"],
                   conf["depth_max"], conf["feature_color_patch"],
                   conf["feature_depth"], conf["feature_height"],
                   conf["feature_normal"])


def features(rgb: torch.Tensor, depth_mm: torch.Tensor, kinv, rot, trans,
             cfg: FrameConfig, dtype=torch.float32):
    """One frame's grid features: -> (features [P, D] float32, mask [P],
    depth grid [gh, gw] in metres, 0 where masked). The depth, height and
    normal features are rounded to ``dtype``; patch bytes are exact."""
    s = cfg.stride
    d_f = depth_mm.to(torch.float32)
    grid = d_f[::s, ::s]
    lo = torch.tensor(cfg.d_min, dtype=torch.float32) * 1000.0
    hi = torch.tensor(cfg.d_max, dtype=torch.float32) * 1000.0
    mask2d = (grid >= lo.to(grid.device)) & (grid <= hi.to(grid.device))
    depth_m = grid * 0.001
    depth_grid = torch.where(mask2d, depth_m, torch.zeros_like(depth_m))
    gh, gw = grid.shape
    parts = []
    if cfg.use_color_patch:
        lab = reflect_pad(rgb_to_lab8(rgb), cfg.patch_size)
        p = patches(lab, depth_grid, cfg.patch_size, cfg.patch_size_reduce, s)
        parts.append(p.reshape(gh * gw, -1).to(torch.float32))
    tail = []
    if cfg.use_depth:
        tail.append(depth_m.reshape(-1, 1))
    if cfg.use_height or cfg.use_normal:
        pts = backproject(d_f, kinv, rot, trans, cfg.d_min, cfg.d_max)
        if cfg.use_height:
            tail.append(torch.nan_to_num(pts[::s, ::s, 2]).reshape(-1, 1))
        if cfg.use_normal:
            tail.append(normal_angles_grid(pts, s).reshape(-1, 1))
    parts += [t.to(dtype).to(torch.float32) for t in tail]
    mask = mask2d.reshape(-1)
    feats = torch.cat(parts, dim=1)
    return (torch.where(mask[:, None], feats, torch.zeros_like(feats)), mask,
            depth_grid)


# ----------------------------------------------------------------------
# The forest (libforest's DecisionTree / RandomForest, multi-label)
# ----------------------------------------------------------------------


@dataclass
class Tree:
    split: np.ndarray  # [n] int64 feature index
    threshold: np.ndarray  # [n] float32
    left: np.ndarray  # [n] int64, 0 = leaf, right child = left + 1
    hist: np.ndarray  # [n, L, C_max] float32 leaf log-histograms


def read_forest(path: str, class_counts: Sequence[int]) -> List[Tree]:
    """Decode a libforest ``forest.dat``: an int32 tree count, then per tree
    the vectors splitFeatures, thresholds, leftChild, histograms and
    multi_histograms (each an int32 length and its items, little endian)."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0

    def i32():
        nonlocal pos
        v = struct.unpack_from("<i", data, pos)[0]
        pos += 4
        return v

    def vec(dtype):
        nonlocal pos
        n = i32()
        a = np.frombuffer(data, dtype=dtype, count=n, offset=pos)
        pos += n * np.dtype(dtype).itemsize
        return a

    trees = []
    c_max = max(class_counts)
    for _ in range(i32()):
        split = vec("<i4").astype(np.int64)
        thr = vec("<f4").astype(np.float32)
        left = vec("<i4").astype(np.int64)
        for _ in range(i32()):  # single-label histograms: not used
            vec("<f4")
        hist = np.zeros((len(split), len(class_counts), c_max), np.float32)
        for node in range(i32()):
            for layer in range(i32()):
                h = vec("<f4")
                hist[node, layer, : len(h)] = h
        trees.append(Tree(split, thr, left, hist))
    if pos != len(data):
        raise ValueError(f"{path}: {len(data) - pos} bytes after the last tree")
    return trees


class Forest:
    """The trees' tables on one device."""

    def __init__(self, trees: List[Tree], device):
        self.trees = [
            tuple(torch.from_numpy(a).to(device) for a in
                  (t.split, t.threshold, t.left, t.hist))
            for t in trees
        ]

    def leaves(self, feats: torch.Tensor) -> Tuple[torch.Tensor, List[int]]:
        """Each point's leaf in each tree, [P, T], and per tree the number of
        (point, level) comparisons made on the way."""
        out, compares = [], []
        rows = torch.arange(feats.shape[0], device=feats.device)
        for split, thr, left, _ in self.trees:
            node = torch.zeros(feats.shape[0], dtype=torch.int64,
                               device=feats.device)
            n = 0
            while True:
                lc = left[node]
                active = lc != 0
                k = int(active.sum())
                if k == 0:
                    break
                n += k
                x = feats[rows, split[node]]
                node = torch.where(active, lc + (x >= thr[node]).long(), node)
            out.append(node)
            compares.append(n)
        return torch.stack(out, dim=1), compares

    def reads(self, feats: torch.Tensor, patch_features: int) -> dict:
        """What a descent of ``feats`` must read: the distinct (point,
        feature) pairs it compares (patch bytes and floats apart), the
        distinct nodes whose records it loads (leaves included), the
        distinct leaves whose histograms it sums, and its (point, tree,
        level) steps."""
        p, d = feats.shape
        rows = torch.arange(p, device=feats.device)
        touched = torch.zeros((p, d), dtype=torch.bool, device=feats.device)
        records = leaves = levels = 0
        for split, thr, left, _ in self.trees:
            node = torch.zeros(p, dtype=torch.int64, device=feats.device)
            visited = torch.zeros(split.shape[0], dtype=torch.bool,
                                  device=feats.device)
            while True:
                visited[node] = True
                lc = left[node]
                active = lc != 0
                k = int(active.sum())
                if k == 0:
                    break
                levels += k
                f = split[node]
                touched[rows[active], f[active]] = True
                node = torch.where(active, lc + (feats[rows, f] >= thr[node]).long(),
                                   node)
            records += int(visited.sum())
            leaves += int(torch.unique(node).numel())
        return dict(patch=int(touched[:, :patch_features].sum()),
                    float=int(touched[:, patch_features:].sum()),
                    records=records, leaves=leaves, levels=levels)

    def posteriors(self, feats: torch.Tensor, dtype=torch.float32):
        """[P, L, C_max]: the leaves' log-histograms summed in tree order, in
        ``dtype``."""
        leaves, _ = self.leaves(feats)
        acc = None
        for t, (_, _, _, hist) in enumerate(self.trees):
            h = hist.to(dtype)[leaves[:, t]]
            acc = h if acc is None else acc + h
        return acc


# ----------------------------------------------------------------------
# Full-resolution posteriors and labels (test_multi.cpp:181-216)
# ----------------------------------------------------------------------


def _taps(dst: int, src: int, device):
    scale = torch.tensor(src / dst, dtype=torch.float32, device=device)
    fx = (torch.arange(dst, dtype=torch.float32, device=device) + 0.5) * scale - 0.5
    i0 = torch.floor(fx).to(torch.int64)
    frac = fx - i0.to(torch.float32)
    frac = torch.where(i0 < 0, torch.zeros_like(frac), frac)
    i0 = torch.clamp(i0, min=0)
    frac = torch.where(i0 >= src - 1, torch.zeros_like(frac), frac)
    i0 = torch.clamp(i0, max=src - 1)
    return i0, torch.clamp(i0 + 1, max=src - 1), frac


def resize(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear ``cv::resize`` of an [h, w, C] map, in its dtype."""
    h, w = img.shape[:2]
    y0, y1, fy = _taps(out_h, h, img.device)
    x0, x1, fx = _taps(out_w, w, img.device)
    fy = fy.to(img.dtype)[:, None, None]
    fx = fx.to(img.dtype)[None, :, None]
    vert = img[y0] * (1.0 - fy) + img[y1] * fy
    return vert[:, x0] * (1.0 - fx) + vert[:, x1] * fx


def frame_outputs(post: torch.Tensor, mask: torch.Tensor, grid: Tuple[int, int],
                  class_counts: Sequence[int], fill: float, h: int, w: int):
    """Stride posteriors [P, L, C_max] -> (per-layer full-resolution
    posteriors [H, W, C_l], per-layer int8 labels [H, W], -1 = no vote)."""
    gh, gw = grid
    posts, labels = [], []
    for li, c in enumerate(class_counts):
        layer = torch.where(mask[:, None], post[:, li, :c],
                            torch.full((), fill, dtype=post.dtype,
                                       device=post.device))
        full = resize(layer.reshape(gh, gw, c), h, w)
        lbl = torch.argmax(full, dim=-1).to(torch.int8)
        lbl = torch.where(full.amax(dim=-1) > -1000.0, lbl, torch.full_like(lbl, -1))
        posts.append(full)
        labels.append(lbl)
    return posts, labels


def run_frame(rgb, depth_mm, kinv, rot, trans, cfg: FrameConfig, forest: Forest,
              class_counts: Sequence[int], fill: float, dtype=torch.float32):
    """One keyframe through the whole frame path: -> (posteriors, labels)."""
    feats, mask, _ = features(rgb, depth_mm, kinv, rot, trans, cfg, dtype)
    post = forest.posteriors(feats, dtype)
    h, w = depth_mm.shape
    s = cfg.stride
    return frame_outputs(post, mask, (-(-h // s), -(-w // s)), class_counts,
                         fill, h, w)
