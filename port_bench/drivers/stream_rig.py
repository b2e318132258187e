"""Closed-loop offline relabelling of a logged rig run through
``StreamingPipeline.run_staged``: ``stream.py``'s cell with every keyframe
node carrying one frame from each camera of the configuration's ``rig``.

A call of ``run_staged`` takes ``batch`` whole nodes: ``batch * C`` frames
of ``C`` cameras, node-major and camera-minor, each with its own camera's
extrinsic (``reference/rig.py::extrinsics``), in one descent; then each of
its maps, every ``map_every`` nodes, fuses all its (node, camera) views.
Camera ``c`` of pool node ``n`` shows pool frame ``C n + c``; staged batch
``b`` holds pool nodes ``batch b`` .. ``batch (b + 1) - 1``, and window
batch ``i`` is staged batch ``i mod n`` perturbed by ``i + 1``
(``gen.perturb``). Node poses are the identity. A map's points are
backprojected from its nodes' frames, ``map_points / (map_every C)`` a
(node, camera) view, each under its camera's extrinsic, with the colours of
their pixels. A keyframe is a node: the metrics per keyframe are per node.

Each window and traced section records in its ``info`` the frames
``run_staged`` took (``streaming.frames``), the descents launched
(``forest_cuda.launches``) and the (node, camera) views fused
(``fusion.views``), from the port's counters, over the section's batches
(a traced section's plain and profiled passes, not its replay); ``null``
where the program has no such counter.

``check`` recomputes a sample of the window's batches with the plain
reference: every frame under its camera's extrinsic (``reference/frame.py``)
and every map through the rig's fusion and labels (``reference/rig.py``,
with ``lattice.py::crf_labels`` when ``use_dense_crf``).
"""

from __future__ import annotations

from typing import Dict, Optional

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
from rovinasemanticsegmentation_tpu_torch.utils import profiling
from rovinasemanticsegmentation_tpu_torch.utils.calibration import Calibration
from rovinasemanticsegmentation_tpu_torch.utils.config import Config

from port_bench import gen, roofline
from port_bench.common import FILL, Setting, mismatch, reference_forest
from port_bench.drivers import stream
from port_bench.reference import frame as ref_frame
from port_bench.reference import lattice as ref_lattice
from port_bench.reference import rig as ref_rig

COUNTERS = ("streaming.frames", "forest_cuda.launches", "fusion.views")


def counts() -> Dict[str, Optional[int]]:
    """The port's counters of this cell; None for one the program lacks (the
    port makes each when its module is imported)."""
    made = getattr(profiling, "_counters", {})
    return {n: (made[n].value if n in made else None) for n in COUNTERS}


class Cell(stream.Cell):
    def __init__(self, spec, seed: int, device: str):
        self.s = s = Setting(spec.config, spec.root)
        t = spec.traffic
        conf = spec.config
        self.seed = seed
        self.dev = dev = resolve_device(device)
        self.rig = ref_rig.extrinsics(conf)
        self.cams = c3 = len(self.rig)
        self.batch, self.k = int(t["batch"]), int(t["map_every"])  # in nodes
        self.maps_per_batch = self.batch // self.k
        self.frames_per_batch = fb = self.batch * c3
        self.n_staged = int(t["pool"]) // fb
        self.check_batches, self.trace_batches = int(t["check_batches"]), int(t["trace_batches"])
        self.frames, rng = gen.make_pool(seed, int(t["pool"]), s.h, s.w)
        per = int(t["map_points"]) // (self.k * c3)
        # Per pool frame: its view's points in the base (the node's pose is
        # the identity) and their colours.
        self.views = [self.sample_view(rng, f, per) for f in range(len(self.frames))]

        calibs = [Calibration(intrinsic=s.intrinsic, rotation=rot, translation=trans)
                  for _, rot, trans in self.rig]
        self.fp = SingleFramePipeline(
            FeatureConfig.from_config(Config(data=conf)),
            load_forest(s.forest_path, class_counts=list(s.class_counts)),
            s.stride, dev, fill_value=FILL)
        projector = MultiProjector.from_calibrations(
            calibs, s.h, s.w, min_distance=conf["depth_min"],
            max_distance=conf["depth_max"])
        self.mp = LocalMapPipeline(
            projector, s.class_counts, s.unknown_labels, dev,
            crf=CrfParams(use_dense_crf=conf["use_dense_crf"],
                          xyz_kernel=conf["dcrf_xyz_kernel"],
                          rgb_kernel=conf["dcrf_rgb_kernel"],
                          kernel_weight=conf["dcrf_kernel_weight"],
                          iterations=conf["dcrf_iterations"]))
        self.stream = StreamingPipeline(self.fp, self.mp, self.k)

        def tile(arrays):
            return torch.from_numpy(np.stack(
                [np.asarray(a, np.float32) for a in arrays] * self.batch)).to(dev)

        self.kinv = tile([c.intrinsic_inverse for c in calibs])
        self.rot = tile([c.rotation for c in calibs])
        self.trans = tile([c.translation for c in calibs])
        self.rgb, self.depth, self.clouds, self.cloud_rgb = [], [], [], []
        for b in range(self.n_staged):
            part = self.frames[b * fb:(b + 1) * fb]
            self.rgb.append(torch.from_numpy(np.stack([f[0] for f in part])).to(dev))
            self.depth.append(torch.from_numpy(
                np.stack([f[1] for f in part]).astype(np.int32)).to(dev))
            maps = [self.map_cloud(b, m) for m in range(self.maps_per_batch)]
            self.clouds.append(torch.from_numpy(np.stack([p for p, _ in maps])).to(dev))
            self.cloud_rgb.append(torch.from_numpy(np.stack([c for _, c in maps])).to(dev))
        self.poses = torch.from_numpy(np.stack(
            [pack_poses(projector, [np.eye(4)] * self.k)] * self.maps_per_batch)).to(dev)

        # The vertex bucket for this cloud size, then every staged batch once.
        results = self.fp.run_batch_stacked(self.rgb[0], self.depth[0], self.kinv,
                                            self.rot, self.trans)
        self.mp.run_device(self.clouds[0][0], self.cloud_rgb[0][0], self.nodes(results, 0))
        for b in range(self.n_staged):
            self.run_batch(b, 0)
        self.mp.flush()
        self.map_labels: Dict[int, np.ndarray] = {}
        self.frame_labels: Dict[int, list] = {}

    def sample_view(self, rng, f: int, per: int):
        """``per`` pixels with depth of pool frame ``f``, backprojected and
        put into the base under its camera's extrinsic: -> (points [per, 3]
        float64, colours [per, 3] float32)."""
        rgb, depth = self.frames[f]
        ys, xs = np.nonzero(depth > 0)
        pick = rng.choice(len(ys), per, replace=False)
        ys, xs = ys[pick], xs[pick]
        z = depth[ys, xs].astype(np.float64) * 0.001
        k = self.s.intrinsic
        pts = np.stack([(xs - k[0, 2]) / k[0, 0] * z, (ys - k[1, 2]) / k[1, 1] * z, z],
                       axis=1)
        _, rot, trans = self.rig[f % self.cams]
        return (pts @ rot.astype(np.float64).T + trans,
                rgb[ys, xs].astype(np.float32) / 255.0)

    def map_cloud(self, b: int, m: int):
        """Staged batch ``b``'s map ``m``: its nodes' views, nodes in order
        and cameras in order within a node: -> (points [N, 3], colours [N,
        3]), float32."""
        first = (b * self.batch + m * self.k) * self.cams
        views = self.views[first:first + self.k * self.cams]
        return (np.concatenate([p for p, _ in views]).astype(np.float32),
                np.concatenate([c for _, c in views]))

    def nodes(self, results, m: int):
        c3 = self.cams
        return [MapNodeFrames(pose=self.poses[m, j],
                              posteriors=[results[(m * self.k + j) * c3 + c].posteriors
                                          for c in range(c3)])
                for j in range(self.k)]

    def run_batch(self, b: int, e: int):
        """One call of the streaming step; -> (frame labels on the device,
        map labels as uint8 on the host)."""
        rgb, depth = gen.perturb(self.rgb[b], self.depth[b], e)
        frames, maps = self.stream.run_staged(
            rgb, depth, self.kinv, self.rot, self.trans, self.clouds[b],
            self.cloud_rgb[b], self.poses)
        return frames, torch.cat([l.to(torch.uint8) for m in maps for l in m]).cpu()

    def _window_batch(self, i: int, retain: bool) -> None:
        before = counts()
        super()._window_batch(i, retain)
        for n, v in counts().items():
            self.tally[n] = None if v is None else self.tally[n] + v - before[n]

    def window(self, seconds: float) -> dict:
        self.tally = dict.fromkeys(COUNTERS, 0)
        out = super().window(seconds)
        out["info"].update(cameras=self.cams, frames=out["keyframes"] * self.cams,
                           counters=dict(self.tally))
        return out

    def traced(self):
        self.tally = dict.fromkeys(COUNTERS, 0)
        data = super().traced()
        data.run["info"].update(cameras=self.cams, counters=dict(self.tally))
        return data

    def replay(self, i: int):
        """Batch ``i`` again from this thread through the public entry
        points, with the harness's spans: -> (frame labels, map labels)."""
        from torch.profiler import record_function

        b, (rgb, depth) = self.inputs(i)
        with record_function(stream.FRAME_SPAN):
            results = self.fp.run_batch_stacked(rgb, depth, self.kinv, self.rot,
                                                self.trans)
        labels = []
        for m in range(self.maps_per_batch):
            with record_function(stream.MAP_SPAN):
                labels += self.mp.run_device(self.clouds[b][m], self.cloud_rgb[b][m],
                                             self.nodes(results, m))
        return ([r.labels for r in results],
                torch.cat([l.to(torch.uint8) for l in labels]).cpu().numpy())

    def reference_frame(self, f: int, e: int, dtype=torch.float32):
        """Pool frame ``f`` perturbed by ``e`` through the reference frame
        path under its camera's extrinsic: -> (posteriors, labels)."""
        s = self.s
        rgb, depth = gen.perturb_np(*self.frames[f], e)
        _, rot, trans = self.rig[f % self.cams]
        return ref_frame.run_frame(
            torch.from_numpy(rgb).to(self.dev), torch.from_numpy(depth).to(self.dev),
            s.kinv, rot, trans, s.frame_config,
            reference_forest(s.forest_path, s.class_counts, str(self.dev)),
            s.class_counts, FILL, dtype)

    def least_s(self) -> Dict[str, float]:
        """The least device time, by the reference's reads of the traced
        batches: per launch of kernel A (a frame) and of kernel B (a batch),
        and per node's step: its cameras' frames and its share of a map of
        ``map_every`` nodes' views."""
        s, fb, n = self.s, self.frames_per_batch, self.trace_batches
        pb = 3 * s.conf["patch_size_reduce"] ** 2
        forest = reference_forest(s.forest_path, s.class_counts, str(self.dev))
        padded = (s.h + 2 * s.conf["patch_size"]) * (s.w + 2 * s.conf["patch_size"])
        patches, descents, valid = [], [], []
        for i in range(n):
            b = i % self.n_staged
            feats, points = [], 0
            for f in range(b * fb, (b + 1) * fb):
                rgb, depth = gen.perturb_np(*self.frames[f], i + 1)
                _, rot, trans = self.rig[f % self.cams]
                x, mask, _ = ref_frame.features(
                    torch.from_numpy(rgb).to(self.dev), torch.from_numpy(depth).to(self.dev),
                    s.kinv, rot, trans, s.frame_config)
                feats.append(x)
                points += mask.numel()
                valid.append(int(mask.sum()))
                patches.append(roofline.patches_bound_s(padded, mask.numel(), valid[-1], pb))
            r = forest.reads(torch.cat(feats), pb)
            descents.append(roofline.descent_bound_s(
                r["patch"], r["float"], r["records"], r["leaves"], points,
                sum(s.class_counts), r["levels"]))
        classes = sum(s.class_counts)
        key = roofline.keyframe_stages(
            s.h, s.w, s.stride, s.conf["patch_size"], s.conf["patch_size_reduce"],
            classes, len(s.class_counts), int(np.mean(valid)),
            float(np.mean(descents)) / fb)
        pts, cols = self.map_cloud(0, 0)
        feats = np.concatenate([pts * s.conf["dcrf_xyz_kernel"],
                                cols * s.conf["dcrf_rgb_kernel"]], axis=1)
        vertices = ref_lattice.build(feats, "cpu").vertices
        per_map = roofline.map_stages(len(pts), self.k * self.cams, classes, feats.shape[1],
                                      vertices, int(s.conf["dcrf_iterations"])
                                      if s.conf["use_dense_crf"] else 0)
        step = roofline.step_least_s([(name, self.cams * v) for name, v in key],
                                     per_map, self.k)
        return {"patches": float(np.mean(patches)), "descent": float(np.mean(descents)),
                "step": sum(step.values()), **{f"step.{k}": v for k, v in step.items()}}

    def check(self, control: bool = False) -> Dict[str, float]:
        """The sampled batches against the reference: the largest share of
        differing frame labels (per frame and layer) and map labels (per map
        and layer). With ``control``, the reference in bfloat16 stands in for
        the program."""
        s, fb, conf = self.s, self.frames_per_batch, self.s.conf
        rng = np.random.default_rng([self.seed, 11])
        done = sorted(self.frame_labels)
        sample = rng.choice(done, size=min(self.check_batches, len(done)), replace=False)
        rig = [(rot, trans) for _, rot, trans in self.rig]
        dtypes = (torch.float32, torch.bfloat16) if control else (torch.float32,)
        frame_mm = map_mm = 0.0
        for i in sorted(int(x) for x in sample):
            b = i % self.n_staged
            posts = {dt: [] for dt in dtypes}
            for f in range(fb):
                for dt in dtypes:
                    posts[dt].append(self.reference_frame(b * fb + f, i + 1, dt))
                want = posts[torch.float32][-1][1]
                got = posts[torch.bfloat16][-1][1] if control else self.frame_labels[i][f]
                frame_mm = max(frame_mm, mismatch(got, want))
            got_maps = self.map_labels[i].reshape(self.maps_per_batch, len(s.class_counts), -1)
            for m in range(self.maps_per_batch):
                pts, cols = self.map_cloud(b, m)
                p = torch.from_numpy(pts).to(self.dev)
                labels = {}
                for dt in dtypes:
                    first = m * self.k * self.cams
                    nodes = [(np.eye(4), [posts[dt][first + j * self.cams + c][0]
                                          for c in range(self.cams)])
                             for j in range(self.k)]
                    u = ref_rig.unaries(p, nodes, s.intrinsic, rig, conf["depth_min"],
                                        conf["depth_max"], s.h, s.w, dt)
                    labels[dt] = ref_rig.labels(u, p, torch.from_numpy(cols).to(self.dev),
                                                conf, s.class_counts, s.unknown_labels)
                got = labels[torch.bfloat16] if control else got_maps[m]
                map_mm = max(map_mm, mismatch(got, labels[torch.float32]))
        out = {"frame_label_mismatch": frame_mm, "map_label_mismatch": map_mm}
        if hasattr(self, "replay_mismatch"):
            out["replay_label_mismatch"] = self.replay_mismatch
        return out
