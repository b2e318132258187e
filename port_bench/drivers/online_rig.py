"""The online node on its rig of cameras, open loop: ``online.py``'s cell
with every keyframe node carrying one frame from each camera of the
configuration's ``rig``.

Each camera is its own pair of topics (``/<camera>/rgb/image_raw``,
``/<camera>/depth/image_raw``) with its own extrinsic
(``reference/rig.py::extrinsics``). At each due time the harness pushes
each camera's host colour and depth frames under the node's id and calls
``on_new_node`` with that id as every camera's seq: camera ``c`` of node
``n`` shows pool frame ``(C (n - 1) + c) mod pool`` of ``C`` cameras (a
pool that ``C`` divides shows each frame always in the same camera). A map's points are backprojected
from all its nodes' frames, ``map_points / (map_every C)`` a (node,
camera), each under its camera's extrinsic and its node's pose.

Each window and traced section records in its ``info`` the frames the
frame worker segmented (``segmenter.frames``) and the (node, camera) views
the map worker projected (``fusion.views``), from the port's counters;
``null`` where the program has no such counter.

``check`` recomputes a sample of the served maps, drawn from the seed with
the slowest one added, with the plain reference: each (node, camera) frame
under its camera's extrinsic, the rig's fusion (``reference/rig.py``) and
the map's labels.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from rovinasemanticsegmentation_tpu_torch.models.forest import load_forest
from rovinasemanticsegmentation_tpu_torch.serve import segmenter
from rovinasemanticsegmentation_tpu_torch.utils import profiling
from rovinasemanticsegmentation_tpu_torch.utils.calibration import Calibration
from rovinasemanticsegmentation_tpu_torch.utils.config import Config

from port_bench import gen
from port_bench.common import FILL, Setting, mismatch, reference_forest
from port_bench.drivers import online
from port_bench.reference import frame as ref_frame
from port_bench.reference import rig as ref_rig

COUNTERS = ("segmenter.frames", "fusion.views")


def counts() -> Dict[str, Optional[int]]:
    """The port's counters of this cell; None for one the program lacks (the
    port makes each when its module is imported)."""
    made = getattr(profiling, "_counters", {})
    return {n: (made[n].value if n in made else None) for n in COUNTERS}


class Cell(online.Cell):
    def __init__(self, spec, seed: int, device: str, rate: float = None):
        self.s = s = Setting(spec.config, spec.root)
        t = spec.traffic
        self.seed = seed
        self.dev = torch.device(device)
        self.rate = float(rate if rate is not None else t["rate_nodes_per_s"])
        self.k = int(t["map_every"])
        self.step = float(t["step_m"])
        self.check_maps = int(t["check_maps"])
        self.trace_seconds = float(t["trace_seconds"])
        self.rig = ref_rig.extrinsics(spec.config)
        self.cameras = [name for name, _, _ in self.rig]
        self.frames, rng = gen.make_pool(seed, int(t["pool"]), s.h, s.w)
        per = int(t["map_points"]) // (self.k * len(self.rig))
        self.samples = []  # per pool frame: camera-frame points and colours
        for rgb, depth in self.frames:
            ys, xs = np.nonzero(depth > 0)
            pick = rng.choice(len(ys), per, replace=False)
            ys, xs = ys[pick], xs[pick]
            z = depth[ys, xs].astype(np.float64) * 0.001
            k = s.intrinsic
            pts = np.stack([(xs - k[0, 2]) / k[0, 0] * z,
                            (ys - k[1, 2]) / k[1, 1] * z, z], axis=1)
            self.samples.append((pts, rgb[ys, xs].astype(np.float32) / 255.0))
        # (pool frame, camera, dtype) -> the reference's posteriors
        self._reference: Dict[tuple, list] = {}

        topics = [f"/{name}/{kind}/image_raw" for name in self.cameras
                  for kind in ("rgb", "depth")]
        self.seg = segmenter.Segmenter(
            Config(data=spec.config), topics, device,
            forest=load_forest(s.forest_path, class_counts=list(s.class_counts)))
        self.seg.initialize_projector(
            self.cameras,
            [Calibration(intrinsic=s.intrinsic, rotation=rot, translation=trans)
             for _, rot, trans in self.rig], (s.h, s.w))
        self.next_node = 1
        self.next_map = 0
        self.maps = {}  # map -> (first node, due)
        self.served = {}
        for w in range(int(t["warmup_maps"])):
            self.drive(0.0, self.rate if w % 2 else float("inf"), nodes=self.k)
        self.maps.clear()
        self.served.clear()

    def frame_index(self, node: int, camera: int) -> int:
        return (len(self.rig) * (node - 1) + camera) % len(self.frames)

    def map_node(self, node: int) -> segmenter.MapNode:
        return segmenter.MapNode(node, self.pose(node), [node] * len(self.rig))

    def send_node(self) -> int:
        node = self.next_node
        for c, name in enumerate(self.cameras):
            rgb, depth = self.frames[self.frame_index(node, c)]
            self.seg.push_color(name, node, rgb)
            self.seg.push_depth(name, node, depth)
        if not self.seg.on_new_node(self.map_node(node)):
            raise RuntimeError(f"node {node} was gated out")
        self.next_node += 1
        return node

    def cloud(self, first: int):
        """The map of nodes ``first`` .. ``first + map_every - 1``: -> (world
        points [N, 3], colours [N, 3]), float32, nodes in order and cameras
        in order within a node."""
        pts, cols = [], []
        for n in range(first, first + self.k):
            pose = self.pose(n).astype(np.float64)
            for c, (_, rot, trans) in enumerate(self.rig):
                p, col = self.samples[self.frame_index(n, c)]
                base = p @ rot.astype(np.float64).T + trans
                pts.append(base @ pose[:3, :3].T + pose[:3, 3])
                cols.append(col)
        return np.concatenate(pts).astype(np.float32), np.concatenate(cols)

    def send_map(self, first: int) -> int:
        pts, cols = self.cloud(first)
        map_id = self.next_map
        self.seg.on_new_local_map(segmenter.LocalMapData(
            map_id, [self.map_node(n) for n in range(first, first + self.k)],
            pts, cols))
        self.next_map += 1
        return map_id

    def drive(self, seconds: float, rate: float, nodes: int = None) -> dict:
        before = counts()
        d = super().drive(seconds, rate, nodes)
        d["counters"] = {n: (None if v is None else counts()[n] - v)
                         for n, v in before.items()}
        return d

    def _summary(self, d: dict) -> dict:
        return dict(super()._summary(d), cameras=len(self.rig), counters=d["counters"])

    def reference_posteriors(self, node: int, camera: int, dtype) -> list:
        """Camera ``camera``'s frame of ``node`` through the reference frame
        path under that camera's extrinsic (each once per check)."""
        key = (self.frame_index(node, camera), camera, dtype)
        if key not in self._reference:
            s = self.s
            rgb, depth = self.frames[key[0]]
            _, rot, trans = self.rig[camera]
            self._reference[key] = ref_frame.run_frame(
                torch.from_numpy(np.ascontiguousarray(rgb)).to(self.dev),
                torch.from_numpy(depth.astype(np.int32)).to(self.dev),
                s.kinv, rot, trans, s.frame_config,
                reference_forest(s.forest_path, s.class_counts, str(self.dev)),
                s.class_counts, FILL, dtype)[0]
        return self._reference[key]

    def check(self, control: bool = False) -> Dict[str, float]:
        """A sample of the served maps against the reference: the largest
        share of differing labels per map and layer, and the maps never
        served. With ``control``, the reference in bfloat16 stands in for
        the program."""
        s, conf = self.s, self.s.conf
        d = self.last
        served = [m for m in d["sent"] if m in self.served]
        rng = np.random.default_rng([self.seed, 13])
        sample = set(int(m) for m in rng.choice(
            served, size=min(self.check_maps, len(served)), replace=False))
        if served:
            sample.add(max(served, key=lambda m: d["latencies"][d["sent"].index(m)]))
        rig = [(rot, trans) for _, rot, trans in self.rig]
        worst = 0.0
        for map_id in sorted(sample):
            first, _ = self.maps[map_id]
            pts, cols = self.cloud(first)
            p = torch.from_numpy(pts).to(self.dev)
            labels = {}
            for dt in ((torch.float32, torch.bfloat16) if control else (torch.float32,)):
                nodes = [(self.pose(n), [self.reference_posteriors(n, c, dt)
                                         for c in range(len(self.rig))])
                         for n in range(first, first + self.k)]
                u = ref_rig.unaries(p, nodes, s.intrinsic, rig, conf["depth_min"],
                                    online.FAR, s.h, s.w, dt)
                labels[dt] = ref_rig.labels(u, p, torch.from_numpy(cols).to(self.dev),
                                            conf, s.class_counts, s.unknown_labels)
            got = (labels[torch.bfloat16] if control else
                   np.asarray(self.served[map_id][1]).reshape(len(s.class_counts), -1))
            worst = max(worst, mismatch(got, labels[torch.float32]))
        self._reference.clear()
        return {"map_label_mismatch": worst, "maps_never_served": d["unserved"]}
