"""Closed-loop offline relabelling through ``StreamingPipeline.run_staged``.

A pool of keyframes made from the seed is staged on the device in batches;
window batch ``i`` is staged batch ``i mod n`` perturbed on the device by
``i + 1`` (``gen.perturb``), so no two batches see the same input. One call
of ``run_staged`` runs the batch's frames (features with kernels A and B,
resize, argmax) and then each of its maps (fusion, device lattice build,
mean field, labels); the batch ends when its maps' labels are on the host
as uint8. The next batch starts when the last one has ended (one client
waiting for each reply). Set-up validates the lattice's vertex bucket with
one map through ``LocalMapPipeline.run_device`` and runs every staged batch
once.

``check`` recomputes a sample of the window's batches, drawn from the seed,
with the plain reference: every keyframe's labels and every map's labels.
The traced section runs ``trace_batches`` batches, then the same batches
under the profiler, then replays them from this thread through the port's public entry points
(``SingleFramePipeline.run_batch_stacked``, ``LocalMapPipeline.run_device``)
with the harness's spans around the frame path and each map.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch

from rovinasemanticsegmentation_tpu_torch.device import resolve_device
from rovinasemanticsegmentation_tpu_torch.features.extractor import FeatureConfig
from rovinasemanticsegmentation_tpu_torch.fusion.projector import MultiProjector
from rovinasemanticsegmentation_tpu_torch.models.forest import load_forest
from rovinasemanticsegmentation_tpu_torch.pipelines.local_map import (
    CrfParams, LocalMapPipeline, MapNodeFrames)
from rovinasemanticsegmentation_tpu_torch.pipelines.single_frame import SingleFramePipeline
from rovinasemanticsegmentation_tpu_torch.pipelines.streaming import (
    StreamingPipeline, pack_poses)
from rovinasemanticsegmentation_tpu_torch.utils.calibration import Calibration
from rovinasemanticsegmentation_tpu_torch.utils.config import Config

from port_bench import gen, roofline
from port_bench.common import FILL, Setting, mismatch, reference_forest, reference_frame
from port_bench.reference import frame as ref_frame
from port_bench.reference import fusion as ref_fusion
from port_bench.reference import lattice as ref_lattice
from port_bench.trace import Trace, TracedRun, activities, sync

FRAME_SPAN = "port_bench: frame path"
MAP_SPAN = "port_bench: map path"
# The first batch and one in 8 after it, from an offset drawn from the seed,
# keep their frame labels on the device for the check.
RETAIN_EVERY = 8


class Cell:
    def __init__(self, spec, seed: int, device: str):
        self.s = s = Setting(spec.config, spec.root)
        t = spec.traffic
        self.seed = seed
        self.dev = dev = resolve_device(device)
        self.batch, self.k = int(t["batch"]), int(t["map_every"])
        self.maps_per_batch = self.batch // self.k
        self.n_staged = int(t["pool"]) // self.batch
        self.check_batches, self.trace_batches = int(t["check_batches"]), int(t["trace_batches"])
        self.frames, rng = gen.make_pool(seed, int(t["pool"]), s.h, s.w)
        self.cloud, cloud_rgb = gen.make_cloud(rng, self.frames, s.focal, s.h, s.w,
                                               self.k, int(t["map_points"]))
        self.cloud_rgb_np = cloud_rgb

        conf = spec.config
        calib = Calibration(intrinsic=s.intrinsic, rotation=np.eye(3),
                            translation=np.zeros(3))
        self.fp = SingleFramePipeline(
            FeatureConfig.from_config(Config(data=conf)),
            load_forest(s.forest_path, class_counts=list(s.class_counts)),
            s.stride, dev, fill_value=FILL)
        projector = MultiProjector.from_calibrations(
            [calib], s.h, s.w, min_distance=conf["depth_min"],
            max_distance=conf["depth_max"])
        self.mp = LocalMapPipeline(
            projector, s.class_counts, s.unknown_labels, dev,
            crf=CrfParams(use_dense_crf=conf["use_dense_crf"],
                          xyz_kernel=conf["dcrf_xyz_kernel"],
                          rgb_kernel=conf["dcrf_rgb_kernel"],
                          kernel_weight=conf["dcrf_kernel_weight"],
                          iterations=conf["dcrf_iterations"]))
        self.stream = StreamingPipeline(self.fp, self.mp, self.k)

        def tile(a):
            a = np.asarray(a, np.float32)
            return torch.from_numpy(np.tile(a[None], (self.batch,) + (1,) * a.ndim)).to(dev)

        self.kinv, self.rot, self.trans = (tile(calib.intrinsic_inverse),
                                           tile(calib.rotation), tile(calib.translation))
        self.rgb, self.depth, self.clouds = [], [], []
        for b in range(self.n_staged):
            part = self.frames[b * self.batch:(b + 1) * self.batch]
            self.rgb.append(torch.from_numpy(np.stack([f[0] for f in part])).to(dev))
            self.depth.append(torch.from_numpy(
                np.stack([f[1] for f in part]).astype(np.int32)).to(dev))
            self.clouds.append(torch.from_numpy(np.stack(
                [self.map_cloud(b, m) for m in range(self.maps_per_batch)])).to(dev))
        self.cloud_rgb = torch.from_numpy(cloud_rgb).to(dev)
        self.poses = torch.from_numpy(np.stack(
            [pack_poses(projector, [np.eye(4)] * self.k)] * self.maps_per_batch)).to(dev)

        # The vertex bucket for this cloud size, then every staged batch once.
        results = self.fp.run_batch_stacked(self.rgb[0], self.depth[0], self.kinv,
                                            self.rot, self.trans)
        self.mp.run_device(self.clouds[0][0], self.cloud_rgb, self.nodes(results, 0))
        for b in range(self.n_staged):
            self.run_batch(b, 0)
        self.mp.flush()
        self.map_labels: Dict[int, np.ndarray] = {}
        self.frame_labels: Dict[int, list] = {}

    def map_cloud(self, b: int, m: int) -> np.ndarray:
        """Staged batch ``b``'s map ``m``: the pool's cloud, moved by a mm per
        map so that no two maps are the same."""
        return self.cloud + np.float32(0.001 * (b * self.maps_per_batch + m))

    def nodes(self, results, m: int):
        return [MapNodeFrames(pose=self.poses[m, j],
                              posteriors=[results[m * self.k + j].posteriors])
                for j in range(self.k)]

    def inputs(self, i: int):
        b = i % self.n_staged
        return b, gen.perturb(self.rgb[b], self.depth[b], i + 1)

    def run_batch(self, b: int, e: int):
        """One call of the streaming step; -> (frame labels on the device,
        map labels as uint8 on the host)."""
        rgb, depth = gen.perturb(self.rgb[b], self.depth[b], e)
        frames, maps = self.stream.run_staged(
            rgb, depth, self.kinv, self.rot, self.trans, self.clouds[b],
            self.cloud_rgb, self.poses)
        return frames, torch.cat([l.to(torch.uint8) for m in maps for l in m]).cpu()

    def _window_batch(self, i: int, retain: bool) -> None:
        frames, labels = self.run_batch(i % self.n_staged, i + 1)
        self.map_labels[i] = labels.numpy()
        if retain:
            self.frame_labels[i] = frames

    def window(self, seconds: float) -> dict:
        offset = int(np.random.default_rng([self.seed, 7]).integers(RETAIN_EVERY))
        overflow0 = self.mp.overflow_maps
        sync(self.dev)
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            self._window_batch(i, i == 0 or i % RETAIN_EVERY == offset)
            i += 1
        elapsed = time.perf_counter() - t0
        self.mp.flush()
        return {"metrics": {"keyframes_per_s": i * self.batch / elapsed},
                "keyframes": i * self.batch, "attempted": i * self.maps_per_batch,
                "failed": self.mp.overflow_maps - overflow0,
                "info": {"batches": i, "keyframes": i * self.batch,
                         "maps": i * self.maps_per_batch, "seconds": elapsed}}

    def replay(self, i: int):
        """Batch ``i`` again from this thread through the public entry
        points, with the harness's spans: -> (frame labels, map labels)."""
        from torch.profiler import record_function

        b, (rgb, depth) = self.inputs(i)
        with record_function(FRAME_SPAN):
            results = self.fp.run_batch_stacked(rgb, depth, self.kinv, self.rot,
                                                self.trans)
        labels = []
        for m in range(self.maps_per_batch):
            with record_function(MAP_SPAN):
                labels += self.mp.run_device(self.clouds[b][m], self.cloud_rgb,
                                             self.nodes(results, m))
        return ([r.labels for r in results],
                torch.cat([l.to(torch.uint8) for l in labels]).cpu().numpy())

    def traced(self) -> TracedRun:
        from torch.profiler import profile

        acts = activities(self.dev)
        n = self.trace_batches
        overflow0 = self.mp.overflow_maps
        walls = []
        for prof in (None, profile(activities=acts)):
            sync(self.dev)
            with prof or contextlib.nullcontext():
                t0 = time.perf_counter()
                for i in range(n):
                    self._window_batch(i, True)
                walls.append(time.perf_counter() - t0)
        plain, wall = walls
        real = Trace.from_profile(prof, wall)
        sync(self.dev)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            replayed = [self.replay(i) for i in range(n)]
            replay_wall = time.perf_counter() - t0
        replay = Trace.from_profile(prof, replay_wall, (FRAME_SPAN, MAP_SPAN))
        self.mp.flush()
        self.replay_mismatch = max(
            max([mismatch(f, g) for f, g in zip(self.frame_labels[i], frames)]
                + [mismatch([self.map_labels[i]], [maps])])
            for i, (frames, maps) in enumerate(replayed))
        maps = n * self.maps_per_batch
        return TracedRun(real, n * self.batch, maps,
                         {"attempted": 2 * maps, "failed": self.mp.overflow_maps - overflow0,
                          "info": {"batches": n, "seconds": plain, "traced_seconds": wall,
                                   "replay_seconds": replay_wall}},
                         plain, replay=replay)

    def least_s(self) -> Dict[str, float]:
        """The least device time, by the reference's reads of the traced
        batches: per launch of kernels A and B, and per keyframe's step."""
        s, t, n = self.s, self.batch, self.trace_batches
        pb = 3 * s.conf["patch_size_reduce"] ** 2
        forest = reference_forest(s.forest_path, s.class_counts, str(self.dev))
        patches, descents, valid = [], [], []
        for i in range(n):
            b = i % self.n_staged
            feats, masks = [], []
            for f in range(t):
                rgb, depth = gen.perturb_np(*self.frames[b * t + f], i + 1)
                x, mask, _ = ref_frame.features(
                    torch.from_numpy(rgb).to(self.dev), torch.from_numpy(depth).to(self.dev),
                    s.kinv, np.eye(3), np.zeros(3), s.frame_config)
                feats.append(x)
                masks.append(mask)
                p = mask.numel()
                valid.append(int(mask.sum()))
                padded = (s.h + 2 * s.conf["patch_size"]) * (s.w + 2 * s.conf["patch_size"])
                patches.append(roofline.patches_bound_s(padded, p, valid[-1], pb))
            r = forest.reads(torch.cat(feats), pb)
            descents.append(roofline.descent_bound_s(
                r["patch"], r["float"], r["records"], r["leaves"], len(masks) * p,
                sum(s.class_counts), r["levels"]))
        classes = sum(s.class_counts)
        key = roofline.keyframe_stages(
            s.h, s.w, s.stride, s.conf["patch_size"], s.conf["patch_size_reduce"],
            classes, len(s.class_counts), int(np.mean(valid)),
            float(np.mean(descents)) / t)
        feats = np.concatenate([self.map_cloud(0, 0) * s.conf["dcrf_xyz_kernel"],
                                self.cloud_rgb_np * s.conf["dcrf_rgb_kernel"]], axis=1)
        vertices = ref_lattice.build(feats, "cpu").vertices
        per_map = roofline.map_stages(len(self.cloud), self.k, classes, feats.shape[1],
                                      vertices, int(s.conf["dcrf_iterations"])
                                      if s.conf["use_dense_crf"] else 0)
        step = roofline.step_least_s(key, per_map, self.k)
        return {"patches": float(np.mean(patches)), "descent": float(np.mean(descents)),
                "step": sum(step.values()), **{f"step.{k}": v for k, v in step.items()}}

    def release(self) -> None:
        """Frees the port's state; what the window produced stays."""
        for i in list(self.frame_labels):
            self.frame_labels[i] = [[l.cpu() for l in f] for f in self.frame_labels[i]]
        del self.stream, self.mp, self.fp, self.rgb, self.depth, self.clouds
        del self.cloud_rgb, self.poses, self.kinv, self.rot, self.trans
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> Dict[str, float]:
        """The sampled batches against the reference: the largest share of
        differing frame labels (per keyframe and layer) and map labels (per
        map and layer). With ``control``, the reference in bfloat16 stands
        in for the program."""
        s, t = self.s, self.batch
        rng = np.random.default_rng([self.seed, 11])
        done = sorted(self.frame_labels)
        sample = rng.choice(done, size=min(self.check_batches, len(done)), replace=False)
        frame_mm = map_mm = 0.0
        conf = s.conf
        for i in sorted(int(x) for x in sample):
            b = i % self.n_staged
            nodes = {torch.float32: [], torch.bfloat16: []}
            for f in range(t):
                rgb, depth = gen.perturb_np(*self.frames[b * t + f], i + 1)
                for dt in ((torch.float32, torch.bfloat16) if control else (torch.float32,)):
                    nodes[dt].append(reference_frame(s, rgb, depth, self.dev, dt))
                want = nodes[torch.float32][-1][1]
                got = nodes[torch.bfloat16][-1][1] if control else self.frame_labels[i][f]
                frame_mm = max(frame_mm, mismatch(got, want))
            got_maps = self.map_labels[i].reshape(self.maps_per_batch, len(s.class_counts), -1)
            for m in range(self.maps_per_batch):
                pts = torch.from_numpy(self.map_cloud(b, m)).to(self.dev)
                cols = torch.from_numpy(self.cloud_rgb_np).to(self.dev)
                labels = {}
                for dt, frames in nodes.items():
                    if not frames:
                        continue
                    node_posts = [(np.eye(4), frames[m * self.k + j][0]) for j in range(self.k)]
                    u = ref_fusion.unaries(pts, node_posts, s.intrinsic, np.eye(3), np.zeros(3),
                                           conf["depth_min"], conf["depth_max"], s.h, s.w, dt)
                    labels[dt] = ref_lattice.crf_labels(u, pts, cols, conf, s.class_counts,
                                                        s.unknown_labels)
                got = labels[torch.bfloat16] if control else got_maps[m]
                map_mm = max(map_mm, mismatch(got, labels[torch.float32]))
        out = {"frame_label_mismatch": frame_mm, "map_label_mismatch": map_mm}
        if hasattr(self, "replay_mismatch"):
            out["replay_label_mismatch"] = self.replay_mismatch
        return out
