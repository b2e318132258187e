"""End-to-end bench of the port: keyframes/s through the keyframe-to-labelled-map path.

Usage (from the repository root):

    python -m rovinasemanticsegmentation_tpu_torch.bench [--device cuda|cpu]
        [--seed 0] [--epochs 12] [--curve-epochs 2]

The counterpart of ``bench.py``'s ``_run_bench`` for the PyTorch/CUDA port,
on the card by default (``--device cpu`` runs the kernels' plain versions on
the CPU; without a card and without it, the bench raises). The workload is
``bench.py``'s, made from ``--seed``: 30 VGA keyframes (Xtion intrinsics
525 / 320 / 240) with piecewise-smooth depth (:func:`make_depth`), one local
map of 30000 surface points every 5 keyframes (:func:`make_cloud`), the
trained fixture forest ``resources/bench_forest.dat`` (4 trees, 8 + 9
classes, Unknown labels 7 and 8; there is no fallback forest: another forest
is another workload), stride 2, the default ``FeatureConfig``, and the dense
CRF on with 10 mean-field iterations. The keyframes, clouds and poses are
staged on the device before any timed region; every epoch perturbs the
staged frames on the device (the RGB XORed, depth raised where it is
nonzero), so no two epochs see the same input.

Cells, one mode each at ``batch`` (10) keyframes per dispatch, 2 maps per
dispatch, a closed loop of ``--epochs`` (12) timed epochs of 30 keyframes:

- ``workers_b10``: ``SingleFramePipeline.run_batch_stacked`` per batch in the
  main thread, and one map worker thread calling
  ``LocalMapPipeline.run_device`` per map, the reference node's one frame
  worker and one map worker (``segmenter.cpp:227-232``);
- ``stream_b10``: ``StreamingPipeline.run_staged`` per batch.

Both warm up with one map through ``run_device`` (which validates the vertex
bucket for the cloud size) and one untimed epoch. Every epoch ends with one
device-side concatenation of every map's labels as uint8, copied to the
host. Before the cells, in the same process: the first batch's frame and map
labels of both modes must be equal, and one keyframe and one map on the
device must match the plain CPU path (frame labels equal except float32
near-ties, the map's mean field within rtol 2e-4 / atol 2e-5); the result is
each line's ``correct``, and the process exits 1 if it is false.

Each cell's JSON line gives keyframes/s as the median and quartiles of its
epochs; stage rows (the frame path per keyframe and the map path per map,
each timed alone, so unlike the headline they do not overlap); the launches
of kernels A, ``pack_lab`` and B in the timed epochs; the maps whose lattice
overflowed its vertex bucket (labelled Unknown) against the maps attempted;
and, on the card, a traced run apart from the timed epochs, in a spawned
process of its own (a profiler window slows the launches of the process it
ran in): one epoch of the cell's own path under ``torch.profiler`` (device
busy time and idle
share, device activities per keyframe, A, ``pack_lab`` and B per launch
beside their bounds, the top 10 device operations) and the same epoch
replayed on one thread with spans from this file around the frame path and
the map's fusion, lattice build and mean field (device ms and activities
per keyframe and per map). Before the cells, ``--curve-epochs`` epochs of
both modes at 5, 10 and 15 keyframes per dispatch print informational curve
lines. A summary line ends the output. Every line names the device.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import multiprocessing
import os
import platform
import statistics
import sys
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict, dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .device import resolve_device
from .features.extractor import (
    FeatureConfig,
    extract_feature_rows,
    feature_row_layout,
    patch_inputs,
)
from .fusion.projector import MultiProjector
from .models.crf import potts_mean_field_multi_t, symmetric_norm
from .models.forest import load_forest
from .models.lattice import build_lattice_device
from .ops import forest_cuda, patches_cuda
from .ops.feature_rows import unpack_rows
from .pipelines.local_map import (
    CrfParams,
    LocalMapPipeline,
    MapNodeFrames,
    _VertexCountProbe,
    crf_feats,
    crf_labels_multi,
)
from .pipelines.single_frame import SingleFramePipeline
from .pipelines.streaming import StreamingPipeline, pack_poses
from .utils.calibration import Calibration
from .utils.profiling import device_busy_ms
from .utils.roofline import (
    PACK_OPS,
    bound,
    descent_bound,
    descent_reads,
    resample_bound,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "resources", "bench_forest.dat")
CLASS_COUNTS = (8, 9)
UNKNOWN_LABELS = (7, 8)
STRIDE = 2
FOCAL = 525.0  # Xtion VGA intrinsics; the principal point is the centre
CRF = CrfParams(use_dense_crf=True, iterations=10)
MODES = ("workers", "stream")
# Spans of the replayed epoch, around the calls into each stage.
FRAME_SPAN = "frame path"
MAP_SPANS = ("fusion", "lattice build", "mean field")
# The port's kernels on the path, by the names the profiler gives them.
KERNELS = {"pack_lab": "pack_lab_kernel", "patches": "patches_kernel",
           "forest_descent": "forest_descent_kernel"}
COUNTERS = {"pack_lab": patches_cuda.pack_launches,
            "patches": patches_cuda.launches,
            "forest_descent": forest_cuda.launches}
# Phase 5's contracts of ``chip_smoke.py``: frame labels equal except where
# a side's top two classes are within TIE_ULPS; posteriors and unaries
# within rtol 1e-5 / atol 1e-4 on >= 99.9% of rows; map labels equal on
# >= 99.9%; mean-field marginals within rtol 2e-4 / atol 2e-5.
TIE_ULPS = 2
AGREE = 0.999
STAGE_REPS = 3


@dataclass(frozen=True)
class Workload:
    """The sizes of ``bench.py``'s workload; the defaults are its own."""

    height: int = 480
    width: int = 640
    keyframes: int = 30  # per epoch
    map_every: int = 5  # keyframes per local map
    map_points: int = 30000
    batch: int = 10  # keyframes per dispatch of the cells
    curve: Tuple[int, ...] = (5, 10, 15)  # the informational batch curve

    def __post_init__(self):
        for b in (self.batch, *self.curve):
            if self.keyframes % b or b % self.map_every:
                raise ValueError(f"batch {b} must divide {self.keyframes} "
                                 f"keyframes and be a multiple of "
                                 f"{self.map_every}")
        if self.map_points % self.map_every:
            raise ValueError("map_points must be a multiple of map_every")


def make_depth(r: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Piecewise-smooth indoor-style depth in mm with sensor noise and 2%
    holes: ``bench.py``'s ``make_depth``, its box sizes as fractions of the
    frame (the same draws at VGA)."""
    ys, xs = np.mgrid[0:h, 0:w]
    depth = (
        3000.0
        + 1500.0 * np.sin(xs / w * np.pi * r.uniform(0.5, 2.0))
        + 1000.0 * (ys / h) * r.uniform(0.5, 3.0)
    )
    for _ in range(6):  # furniture-like fronto-parallel boxes
        y0, x0 = r.integers(0, h - h // 6), r.integers(0, w - 3 * w // 16)
        bh, bw = r.integers(h // 8, 3 * h // 8), r.integers(w // 8, 3 * w // 8)
        depth[y0 : y0 + bh, x0 : x0 + bw] = r.uniform(700, 2500)
    depth += r.normal(0, 15, (h, w))  # sensor noise
    holes = r.random((h, w)) < 0.02  # dropouts
    depth[holes] = 0
    return np.clip(depth, 0, 15500).astype(np.uint16)


def make_cloud(r: np.random.Generator, frames, h: int, w: int, map_every: int,
               map_points: int) -> Tuple[np.ndarray, np.ndarray]:
    """A local map backprojected from the first ``map_every`` keyframes'
    surfaces, with a per-keyframe pose drift (``bench.py``'s ``make_cloud``):
    -> (points [N, 3], RGB in [0, 1] [N, 3]), float32."""
    fx, fy, cx, cy = FOCAL, FOCAL, w / 2, h / 2
    pts, cols = [], []
    per_frame = map_points // map_every
    for f in range(map_every):
        d = frames[f][1].astype(np.float32) / 1000.0
        ys = r.integers(0, h, per_frame)
        xs = r.integers(0, w, per_frame)
        z = d[ys, xs]
        z = np.where(z > 0, z, 2.0)
        pts.append(
            np.stack([(xs - cx) / fx * z, (ys - cy) / fy * z, z], axis=1)
            + np.array([0.05, 0.02, 0.0]) * f  # per-keyframe pose drift
        )
        cols.append(frames[f][0][ys, xs].astype(np.float32) / 255.0)
    return (np.concatenate(pts).astype(np.float32),
            np.concatenate(cols).astype(np.float32))


def make_workload(seed: int, wl: Workload):
    """-> (keyframes [(rgb uint8 [H, W, 3], depth uint16 mm [H, W])], the
    map cloud), drawn from one generator in ``bench.py``'s order."""
    rng = np.random.default_rng(seed)
    h, w = wl.height, wl.width
    frames = [
        (rng.integers(0, 256, (h, w, 3), dtype=np.uint8), make_depth(rng, h, w))
        for _ in range(wl.keyframes)
    ]
    return frames, make_cloud(rng, frames, h, w, wl.map_every, wl.map_points)


def fixture_id(path: str = FIXTURE) -> str:
    """The first 16 hex digits of the fixture's sha256, as ``bench.py``
    prints them; raises if the fixture is missing."""
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def device_info(dev: torch.device) -> dict:
    if dev.type == "cuda":
        from .scripts import card_description

        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count(),
                "name_and_power_limit": card_description()}
    return {"platform": "cpu", "kind": platform.processor() or "cpu",
            "count": 1, "name_and_power_limit": None}


def perturb(rgb: torch.Tensor, depth: torch.Tensor, e: int):
    """A content-varying, validity-preserving tweak of staged frames: the
    RGB XORed with ``e``, ``e`` added to depth where it is nonzero."""
    return rgb ^ (e & 0xFF), torch.where(depth > 0, depth + e, depth)


def quartiles(xs: List[float]) -> dict:
    q1, q2, q3 = (statistics.quantiles(xs, n=4, method="inclusive")
                  if len(xs) > 1 else (xs[0],) * 3)
    return {"median": q2, "q1": q1, "q3": q3, "n": len(xs)}


@dataclass
class Staged:
    """One dispatch size's inputs on the device: per batch the keyframes and
    the clouds of its maps, and the calibration and poses every batch uses."""

    batch: int
    rgb: List[torch.Tensor]  # per batch [B, H, W, 3] uint8
    depth: List[torch.Tensor]  # per batch [B, H, W] int32 mm
    kinv: torch.Tensor  # [B, 3, 3]
    rot: torch.Tensor  # [B, 3, 3]
    trans: torch.Tensor  # [B, 3]
    clouds: List[torch.Tensor]  # per batch [maps per batch, N, 3]
    poses: torch.Tensor  # [maps per batch, map_every, C3, 3, 4]

    @property
    def n_batches(self) -> int:
        return len(self.rgb)

    @property
    def maps_per_batch(self) -> int:
        return int(self.poses.shape[0])


@dataclass
class Cell:
    """One mode at one dispatch size: its map pipeline (so that overflows are
    counted per cell), its map worker, and the maps it dispatched."""

    mode: str
    staged: Staged
    maps: LocalMapPipeline
    pool: Optional[ThreadPoolExecutor] = None
    stream: Optional[StreamingPipeline] = None
    maps_attempted: int = 0
    next_e: int = 1  # every batch of every epoch gets its own perturbation

    def take_e(self) -> int:
        e0, self.next_e = self.next_e, self.next_e + self.staged.n_batches
        return e0


class Bench:
    """The staged workload, the pipelines, and the measurements over them."""

    def __init__(self, device, seed: int = 0, workload: Workload = Workload()):
        self.dev = resolve_device(device)
        self.seed = int(seed)
        self.wl = workload
        self.fixture = fixture_id()
        self.frames, (self.cloud_pts, cloud_rgb) = make_workload(seed, workload)
        h, w = workload.height, workload.width
        self.calib = Calibration(
            intrinsic=np.array([[FOCAL, 0, w / 2], [0, FOCAL, h / 2], [0, 0, 1]]),
            rotation=np.eye(3),
            translation=np.zeros(3),
        )
        self.cfg = FeatureConfig()
        self.forest_np = load_forest(FIXTURE, class_counts=list(CLASS_COUNTS))
        self.frame_pipeline = SingleFramePipeline(
            self.cfg, self.forest_np, STRIDE, self.dev, fill_value=0.0)
        self.projector = MultiProjector.from_calibrations(
            [self.calib], h, w, min_distance=0.5, max_distance=15.0)
        self.cloud_rgb = torch.from_numpy(cloud_rgb).to(self.dev)
        self.device = device_info(self.dev)

    def map_pipeline(self, device=None) -> LocalMapPipeline:
        return LocalMapPipeline(self.projector, CLASS_COUNTS, UNKNOWN_LABELS,
                                device or self.dev, crf=CRF)

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def staged(self, batch: int) -> Staged:
        wl, dev = self.wl, self.dev
        n_batches, maps_per_batch = wl.keyframes // batch, batch // wl.map_every

        def tile(a):  # the same calibration for every keyframe of a batch
            a = np.asarray(a, np.float32)
            return torch.from_numpy(np.tile(a[None], (batch,) + (1,) * a.ndim)
                                    ).to(dev)

        rgb, depth, clouds = [], [], []
        for b in range(n_batches):
            part = self.frames[b * batch : (b + 1) * batch]
            rgb.append(torch.from_numpy(np.stack([f[0] for f in part])).to(dev))
            depth.append(torch.from_numpy(
                np.stack([f[1] for f in part]).astype(np.int32)).to(dev))
            # Distinct clouds per map, the same for every dispatch size.
            clouds.append(torch.from_numpy(np.stack([
                self.cloud_pts + np.float32(0.001 * (b * maps_per_batch + m))
                for m in range(maps_per_batch)
            ])).to(dev))
        poses = pack_poses(self.projector, [np.eye(4)] * wl.map_every)
        return Staged(
            batch, rgb, depth, tile(self.calib.intrinsic_inverse),
            tile(self.calib.rotation), tile(self.calib.translation), clouds,
            torch.from_numpy(np.stack([poses] * maps_per_batch)).to(dev),
        )

    def cell(self, mode: str, batch: int) -> Cell:
        """A cell with its bucket validated: one map through ``run_device``."""
        st = self.staged(batch)
        cell = Cell(mode, st, self.map_pipeline())
        if mode == "workers":
            cell.pool = ThreadPoolExecutor(max_workers=1)
        else:
            cell.stream = StreamingPipeline(self.frame_pipeline, cell.maps,
                                            self.wl.map_every)
        results = self.frame_batch(st, 0, 0)
        cell.maps.run_device(st.clouds[0][0], self.cloud_rgb,
                             self.nodes(cell, results, 0))
        cell.maps_attempted += 1
        return cell

    def frame_batch(self, st: Staged, b: int, e: int):
        rgb, depth = perturb(st.rgb[b], st.depth[b], e)
        return self.frame_pipeline.run_batch_stacked(rgb, depth, st.kinv,
                                                     st.rot, st.trans)

    def nodes(self, cell: Cell, results, m: int) -> List[MapNodeFrames]:
        """Map ``m``'s keyframe nodes: in ``workers`` mode with 4x4 poses, as
        the node receives them, in ``stream`` mode with ``run_staged``'s
        packed poses on the device."""
        k = self.wl.map_every
        return [
            MapNodeFrames(
                pose=np.eye(4) if cell.mode == "workers"
                else cell.staged.poses[m, i],
                posteriors=[r.posteriors])
            for i, r in enumerate(results[m * k : (m + 1) * k])
        ]

    def replay_map(self, mp: LocalMapPipeline, points, rgb, nodes):
        """``LocalMapPipeline.map_fused`` with the bench's spans around its
        stages, and its vertex count probed as ``run_staged`` probes it."""
        from torch.profiler import record_function

        with record_function(MAP_SPANS[0]):
            fused = torch.cat(mp.fuse_unaries(points, nodes), dim=1)
        with record_function(MAP_SPANS[1]):
            *lattice, m = build_lattice_device(
                crf_feats(points, rgb, CRF.xyz_kernel, CRF.rgb_kernel),
                mp._m_bucket)
        with record_function(MAP_SPANS[2]):
            labels = crf_labels_multi(
                fused, lattice, CRF.kernel_weight, mp.class_counts,
                mp._m_bucket, CRF.iterations, mp.unknown_labels,
                m > mp._m_bucket)
        mp._pending_m.append(_VertexCountProbe(mp._m_bucket, m))
        return labels

    def epoch(self, cell: Cell, e0: int, replay: bool = False) -> torch.Tensor:
        """One pass over the staged keyframes in the cell's mode, batch ``b``
        perturbed by ``e0 + b``; -> every map's labels, concatenated on the
        device as uint8 and copied to the host. ``replay`` issues the same
        work from this thread, with spans around each stage."""
        from torch.profiler import record_function

        span = record_function if replay else (lambda _: contextlib.nullcontext())
        st = cell.staged
        labels, pending = [], []
        for b in range(st.n_batches):
            if cell.mode == "stream" and not replay:
                rgb, depth = perturb(st.rgb[b], st.depth[b], e0 + b)
                _, maps = cell.stream.run_staged(
                    rgb, depth, st.kinv, st.rot, st.trans, st.clouds[b],
                    self.cloud_rgb, st.poses)
                labels.extend(l for m in maps for l in m)
                continue
            with span(FRAME_SPAN):
                results = self.frame_batch(st, b, e0 + b)
            for m in range(st.maps_per_batch):
                args = (st.clouds[b][m], self.cloud_rgb,
                        self.nodes(cell, results, m))
                if replay:
                    labels.extend(self.replay_map(cell.maps, *args))
                else:
                    pending.append(cell.pool.submit(cell.maps.run_device, *args))
        labels.extend(l for fut in pending for l in fut.result())
        cell.maps_attempted += st.n_batches * st.maps_per_batch
        return torch.cat([l.to(torch.uint8) for l in labels]).cpu()

    def stage_rows(self, cell: Cell) -> dict:
        """The frame path and the map path, each timed alone (host clock
        around work that ends in a copy of its labels to the host)."""
        st = cell.staged
        frame_ms = []
        for _ in range(STAGE_REPS):
            e0 = cell.take_e()
            self.sync()
            t0 = time.perf_counter()
            batches = [self.frame_batch(st, b, e0 + b)
                       for b in range(st.n_batches)]
            torch.cat([l.reshape(-1).to(torch.uint8)
                       for results in batches for r in results
                       for l in r.labels]).cpu()
            frame_ms.append(1000 * (time.perf_counter() - t0) / self.wl.keyframes)
        map_ms = []
        for b, results in enumerate(batches):
            for m in range(st.maps_per_batch):
                nodes = self.nodes(cell, results, m)
                self.sync()
                t0 = time.perf_counter()
                labels = cell.maps.run_device(st.clouds[b][m], self.cloud_rgb,
                                              nodes)
                torch.cat([l.to(torch.uint8) for l in labels]).cpu()
                map_ms.append(1000 * (time.perf_counter() - t0))
                cell.maps_attempted += 1
        return {
            "overlap": "none: each stage is timed alone, without the other "
                       "in flight; the headline overlaps the frame and map "
                       "paths",
            "frame_path_ms_per_kf": quartiles(frame_ms),
            "map_path_ms_per_map": quartiles(map_ms),
        }

    def kernel_bounds(self, st: Staged, e0: int) -> Dict[str, dict]:
        """Mean bound per launch of A, ``pack_lab`` and B on the inputs of the
        epoch perturbed from ``e0`` (``utils/roofline.py``)."""
        layout = feature_row_layout(self.cfg)
        forest = self.frame_pipeline.forest
        per = defaultdict(list)
        for b in range(st.n_batches):
            rgb, depth = perturb(st.rgb[b], st.depth[b], e0 + b)
            gh, gw = self.frame_pipeline.grid_shape(*depth.shape[1:])
            rows = torch.empty((st.batch * gh * gw, layout.row_bytes),
                               dtype=torch.uint8, device=self.dev)
            for i in range(st.batch):
                padded, dgrid = patch_inputs(rgb[i], depth[i], self.cfg, STRIDE)
                hp, wp, _ = padded.shape
                per["pack_lab"].append(bound(7 * hp * wp, PACK_OPS, hp * wp))
                per["patches"].append(resample_bound(
                    4 * hp * wp, dgrid, layout.patch_bytes, layout.row_bytes))
                extract_feature_rows(rgb[i], depth[i], st.kinv[i], st.rot[i],
                                     st.trans[i], self.cfg, STRIDE, rows,
                                     i * gh * gw)
            reads = descent_reads(unpack_rows(rows, layout), forest)
            per["forest_descent"].append(descent_bound(reads, forest, layout))
        return {
            name: dict(bound_ms=statistics.fmean(x["bound_ms"] for x in bs),
                       bound_by=bs[0]["bound_by"])
            for name, bs in per.items()
        }

    def replay_equal(self, cell: Cell) -> bool:
        """Whether an epoch of the cell's own path and its replay on one
        thread, on the same inputs, give the same labels."""
        e0 = cell.take_e()
        return torch.equal(self.epoch(cell, e0),
                           self.epoch(cell, e0, replay=True))

    def traced(self, cell: Cell) -> dict:
        """:meth:`replay_equal` with each epoch under ``torch.profiler`` on
        the card; -> the per-layer numbers and ``replay_equal``."""
        from torch.profiler import ProfilerActivity, profile

        e0 = cell.take_e()
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        self.sync()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            real = self.epoch(cell, e0)
            wall_ms = 1000 * (time.perf_counter() - t0)
        self.sync()
        with profile(activities=activities) as prof_replay:
            replay = self.epoch(cell, e0, replay=True)
        out = self.epoch_summary(prof.events(), wall_ms,
                                 self.kernel_bounds(cell.staged, e0))
        out["stages"] = self.stage_summary(prof_replay.events())
        out["replay_equal"] = torch.equal(real, replay)
        return out

    def epoch_summary(self, events, wall_ms: float,
                      bounds: Dict[str, dict]) -> dict:
        kf = self.wl.keyframes
        device = [e for e in events if e.device_type.name != "CPU"]
        by_name = defaultdict(lambda: [0.0, 0])
        for e in device:
            by_name[e.name][0] += e.time_range.elapsed_us()
            by_name[e.name][1] += 1
        busy = device_busy_ms(device)
        kernels = {}
        for name, cuda_name in KERNELS.items():
            us = sum(v[0] for k, v in by_name.items() if cuda_name in k)
            n = sum(v[1] for k, v in by_name.items() if cuda_name in k)
            per_launch_ms = us / 1000 / n if n else None
            kernels[name] = dict(
                launches=n, ms_per_launch=per_launch_ms, **bounds[name],
                share_of_bound=bounds[name]["bound_ms"] / per_launch_ms
                if n else None)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
        return {
            "profiled_wall_ms": wall_ms,
            "device_busy_ms_per_keyframe": busy / kf,
            "device_ms_per_keyframe": sum(v[0] for v in by_name.values())
                                      / 1000 / kf,
            "device_idle_share": 1 - busy / wall_ms,
            "device_activities_per_keyframe": len(device) / kf,
            "kernels": kernels,
            "top_ops": [{"name": name[:160], "ms": us / 1000, "count": n}
                        for name, (us, n) in top],
        }

    def stage_summary(self, events) -> dict:
        """Device ms and activities of each span of the replay; an activity
        belongs to the span whose device-side range holds its start."""
        names = (FRAME_SPAN, *MAP_SPANS)
        device = [e for e in events if e.device_type.name != "CPU"]
        windows = [(e.time_range, e.name) for e in device if e.name in names]
        found = {n for _, n in windows}
        if found != set(names):
            raise RuntimeError(f"span ranges on the device: {sorted(found)}")
        sums = defaultdict(lambda: [0.0, 0])
        for e in device:
            if e.name in names:
                continue
            start = e.time_range.start
            owner = next((n for r, n in windows if r.start <= start < r.end),
                         "outside the spans")
            sums[owner][0] += e.time_range.elapsed_us() / 1000
            sums[owner][1] += 1
        kf = self.wl.keyframes
        n_maps = kf // self.wl.map_every
        out = {FRAME_SPAN: {"device_ms_per_keyframe": sums[FRAME_SPAN][0] / kf,
                            "activities_per_keyframe": sums[FRAME_SPAN][1] / kf}}
        for name in MAP_SPANS:
            out[name] = {"device_ms_per_map": sums[name][0] / n_maps,
                         "activities_per_map": sums[name][1] / n_maps}
        out["map"] = {k: sum(out[n][k] for n in MAP_SPANS)
                      for k in ("device_ms_per_map", "activities_per_map")}
        out["activities_outside_the_spans"] = sums["outside the spans"][1]
        return out

    def measure(self, mode: str, batch: int, epochs: int, full: bool) -> dict:
        """Warm up, then ``epochs`` timed epochs of one mode; with ``full``,
        the stage rows and the traced run too."""
        cell = self.cell(mode, batch)
        try:
            self.epoch(cell, cell.take_e())  # warm-up
            self.sync()
            for counter in COUNTERS.values():
                counter.reset()
            rates = []
            for _ in range(epochs):
                e0 = cell.take_e()
                t0 = time.perf_counter()
                self.epoch(cell, e0)
                rates.append(self.wl.keyframes / (time.perf_counter() - t0))
            out = {"mode": mode, "batch": batch,
                   "keyframes_per_s": quartiles(rates), "epochs": rates,
                   "launches": {k: c.value for k, c in COUNTERS.items()}}
            out["trace"] = None
            if full:
                out["stages"] = self.stage_rows(cell)
                if self.dev.type == "cuda":
                    out["trace"] = self.trace_apart(mode, batch)
                    out["trace"]["device_idle_share_of_median_epoch"] = (
                        1 - out["trace"]["device_busy_ms_per_keyframe"]
                        * statistics.median(rates) / 1000)
                    out["replay_equal"] = out["trace"].pop("replay_equal")
                else:
                    out["replay_equal"] = self.replay_equal(cell)
            cell.maps.flush()
            out["lattice_overflow_maps"] = cell.maps.overflow_maps
            out["maps_attempted"] = cell.maps_attempted
            if out["trace"] is not None:  # the traced process's maps
                out["lattice_overflow_maps"] += out["trace"].pop(
                    "lattice_overflow_maps")
                out["maps_attempted"] += out["trace"].pop("maps_attempted")
            return out
        finally:
            if cell.pool is not None:
                cell.pool.shutdown()

    def trace_apart(self, mode: str, batch: int) -> dict:
        """The cell's traced run in a spawned process of its own: a profiler
        window leaves this process's later launches slower, and later cells
        are timed here."""
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(1) as pool:
            return pool.apply(trace_cell, (str(self.dev), self.seed, self.wl,
                                           mode, batch))

    def check_modes_agree(self) -> Tuple[bool, bool]:
        """The first batch of both modes, unperturbed: -> (frame labels
        equal, map labels equal), bit for bit."""
        workers = self.cell("workers", self.wl.batch)
        stream = self.cell("stream", self.wl.batch)
        try:
            st = workers.staged
            results = self.frame_batch(st, 0, 0)
            maps_w = [workers.maps.run_device(st.clouds[0][m], self.cloud_rgb,
                                              self.nodes(workers, results, m))
                      for m in range(st.maps_per_batch)]
            frames_s, maps_s = stream.stream.run_staged(
                st.rgb[0], st.depth[0], st.kinv, st.rot, st.trans,
                st.clouds[0], self.cloud_rgb, st.poses)
            frames_equal = all(
                torch.equal(a, b) for r, f in zip(results, frames_s)
                for a, b in zip(r.labels, f))
            maps_equal = all(
                torch.equal(a, b) for w, s in zip(maps_w, maps_s)
                for a, b in zip(w, s))
            for cell in (workers, stream):
                cell.maps.flush()
            return frames_equal, maps_equal
        finally:
            workers.pool.shutdown()

    def check_against_cpu(self) -> dict:
        """One keyframe and one map on the device against the plain CPU path
        on the same inputs (``chip_smoke.py`` phase 5's contract)."""
        cpu = torch.device("cpu")
        rgb, depth = self.frames[0]
        pts = torch.from_numpy(self.cloud_pts)
        cols = self.cloud_rgb.cpu()
        side = {}
        for name, fp in (("device", self.frame_pipeline),
                         ("cpu", SingleFramePipeline(self.cfg, self.forest_np,
                                                     STRIDE, cpu, fill_value=0.0))):
            res = fp.run(rgb, depth, self.calib)
            mp = self.map_pipeline(fp.device)
            nodes = [MapNodeFrames(pose=np.eye(4), posteriors=[res.posteriors])]
            p, c = pts.to(fp.device), cols.to(fp.device)
            labels = mp.run_device(p, c, nodes)
            mp.flush()
            fused = torch.cat(mp.fuse_unaries(p, nodes), dim=1)
            side[name] = (res, labels, fused.cpu(), mp._m_bucket)
        (res_d, lab_d, fused_d, bucket), (res_c, lab_c, fused_c, _) = (
            side["device"], side["cpu"])
        near_ties = frame_differ = 0
        frames_ok = True
        for post_d, post_c, l_d, l_c in zip(res_d.posteriors, res_c.posteriors,
                                            res_d.labels, res_c.labels):
            post_d, post_c = post_d.cpu().numpy(), post_c.numpy()
            clear = ((top_two_gap_ulps(post_d) > TIE_ULPS)
                     & (top_two_gap_ulps(post_c) > TIE_ULPS))
            differ = l_d.cpu().numpy() != l_c.numpy()
            frames_ok &= not bool((differ & clear).any())
            frame_differ += int(differ.sum())
            near_ties += int((~clear).sum())
        unaries_close = float(torch.isclose(fused_d, fused_c, rtol=1e-5,
                                            atol=1e-4).all(dim=1).double().mean())
        map_agree = min(float((a.cpu() == b).double().mean())
                        for a, b in zip(lab_d, lab_c))
        # The mean field on the same unaries and features, each side's device
        # lattice build with the device's bucket.
        feats = crf_feats(pts, cols, CRF.xyz_kernel, CRF.rgb_kernel)
        q_d, m = mean_field(fused_c.to(self.dev), feats.to(self.dev), bucket)
        q_c, _ = mean_field(fused_c, feats, bucket)
        q_d = q_d.cpu()
        q_err = float((q_d - q_c).abs().max())
        q_ok = bool(torch.isclose(q_d, q_c, rtol=2e-4, atol=2e-5).all())
        return {
            "frame_labels_equal_except_near_ties": frames_ok,
            "frame_labels_differ": frame_differ,
            "frame_near_tie_pixels": near_ties,
            "unaries_close_share": unaries_close,
            "map_labels_agree_share": map_agree,
            "mean_field_max_abs_err": q_err,
            "mean_field_within_tolerance": q_ok,
            "lattice_vertices": int(m),
            "vertex_bucket": int(bucket),
            "ok": (frames_ok and unaries_close >= AGREE
                   and map_agree >= AGREE and q_ok and int(m) <= bucket),
        }


def trace_cell(device: str, seed: int, workload: Workload, mode: str,
               batch: int) -> dict:
    """A cell's traced run (:meth:`Bench.traced`) after a validating map and
    a warm-up epoch, with this process's overflowing maps and maps
    attempted."""
    bench = Bench(device, seed, workload)
    cell = bench.cell(mode, batch)
    try:
        bench.epoch(cell, cell.take_e())  # warm-up
        out = bench.traced(cell)
        cell.maps.flush()
        out["lattice_overflow_maps"] = cell.maps.overflow_maps
        out["maps_attempted"] = cell.maps_attempted
        return out
    finally:
        if cell.pool is not None:
            cell.pool.shutdown()


def top_two_gap_ulps(post: np.ndarray) -> np.ndarray:
    """[H, W, C] -> the gap between the two largest classes, in ulps of the
    largest."""
    top = np.sort(post, axis=-1)[..., -2:]
    return (top[..., 1] - top[..., 0]) / np.spacing(np.abs(top[..., 1]))


def mean_field(unaries: torch.Tensor, feats: torch.Tensor, bucket: int):
    """The map's fused mean-field marginals [C, N] on ``unaries``' device,
    over a device lattice build with ``bucket`` vertex slots; -> (marginals,
    vertex count)."""
    *lattice, m = build_lattice_device(feats, bucket)
    norm = symmetric_norm(lattice, bucket)
    q = potts_mean_field_multi_t(-unaries.T, *lattice, norm, CRF.kernel_weight,
                                 CLASS_COUNTS, bucket, CRF.iterations)
    return q, m


def run(bench: Bench, epochs: int, curve_epochs: int,
        emit: Callable[[dict], None]) -> int:
    """The correctness checks, the curve, then each cell, each line emitted as
    soon as it is measured, then the summary; -> the exit code."""
    wl = bench.wl
    common = {"device": bench.device, "fixture": bench.fixture,
              "seed": bench.seed, "workload": asdict(wl)}
    frames_equal, maps_equal = bench.check_modes_agree()
    checks = {"workers_equal_stream_frame_labels": frames_equal,
              "workers_equal_stream_map_labels": maps_equal,
              "device_vs_cpu": bench.check_against_cpu()}
    correct = frames_equal and maps_equal and checks["device_vs_cpu"]["ok"]
    if curve_epochs:
        for mode in MODES:
            for b in wl.curve:
                m = bench.measure(mode, b, curve_epochs, full=False)
                emit({"curve": f"{mode}_b{b}", "informational": True,
                      "keyframes_per_s": m["keyframes_per_s"],
                      "epochs": m["epochs"], "device": bench.device})
    rates = {}
    for mode in MODES:
        name = f"{mode}_b{wl.batch}"
        m = bench.measure(mode, wl.batch, epochs, full=True)
        cell_ok = correct and m["replay_equal"]
        rates[name] = m["keyframes_per_s"]
        emit({"cell": name, "metric": "keyframes_per_s", "unit": "keyframes/s",
              "loop": "closed", "maps_per_epoch": wl.keyframes // wl.map_every,
              **m, "checks": checks, "correct": cell_ok, **common})
        correct = correct and cell_ok
    emit({"summary": True, "keyframes_per_s": rates,
          "correct": correct, **common})
    return 0 if correct else 1


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=12,
                    help="timed epochs per cell")
    ap.add_argument("--curve-epochs", type=int, default=2,
                    help="epochs per point of the batch curve (0: no curve)")
    args = ap.parse_args(argv)
    bench = Bench(args.device, args.seed)
    return run(bench, args.epochs, args.curve_epochs,
               lambda line: print(json.dumps(line), flush=True))


if __name__ == "__main__":
    sys.exit(main())
