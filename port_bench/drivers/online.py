"""The online node, open loop: ``serve.segmenter.Segmenter`` with its frame
worker and map worker threads, driven as a mapper drives it.

Keyframe nodes are due at a fixed rate from the traffic file, evenly
spaced. At each due time the harness pushes the node's host colour and
depth frames (``push_color``, ``push_depth``; frames cycle a pool made from
the seed) and calls
``on_new_node``; the node's pose advances ``step_m`` along x, so every
node passes the 0.07 m keyframe gate. After every ``map_every``-th node,
``on_new_local_map`` sends a map of ``map_points`` points backprojected from
its nodes' depth under their poses, with colours. A window sends whole maps:
its last nodes are those of a map. Between due times the
harness polls ``stored_semantics_ids`` and fetches each newly stored map
with ``get_local_map_segmentation``. A map's latency runs from the due time
of its last node to the return of that call; a map not served a minute after
the window closes counts to that moment and as failed. Set-up sends
``warmup_maps`` maps, half of them as bursts (which fill the frame worker's
batch ladder), and waits for them.

``check`` recomputes a sample of the served maps, drawn from the seed with
the slowest one added, with the plain reference: its nodes' frames, the
fusion under their poses, and the map's labels.
"""

from __future__ import annotations

import array
import contextlib
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from rovinasemanticsegmentation_tpu_torch.models.forest import load_forest
from rovinasemanticsegmentation_tpu_torch.ops import forest_cuda
from rovinasemanticsegmentation_tpu_torch.serve import segmenter
from rovinasemanticsegmentation_tpu_torch.utils.calibration import Calibration
from rovinasemanticsegmentation_tpu_torch.utils.config import Config

from port_bench import gen
from port_bench.common import Setting, mismatch, reference_frame
from port_bench.harness import quantile
from port_bench.reference import fusion as ref_fusion
from port_bench.reference import lattice as ref_lattice
from port_bench.trace import Trace, TracedRun, activities, sync

CAMERA = "camera_front"
TOPICS = [f"/{CAMERA}/rgb/image_raw", f"/{CAMERA}/depth/image_raw"]
POLL_S = 0.001  # between polls of the stored maps while waiting
GRACE_S = 60.0  # how long a map due in the window is waited for
# The node's projector sets only the near limit of the z-buffer
# (``MultiProjector.from_calibrations(..., min_distance=depth_min)``).
FAR = 1.0e9


class Cell:
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
        self.frames, rng = gen.make_pool(seed, int(t["pool"]), s.h, s.w)
        per = int(t["map_points"]) // self.k
        self.samples = []  # per pool frame: camera-frame points and colours
        for rgb, depth in self.frames:
            ys, xs = np.nonzero(depth > 0)
            pick = rng.choice(len(ys), per, replace=False)
            ys, xs = ys[pick], xs[pick]
            z = depth[ys, xs].astype(np.float64) * 0.001
            k = s.intrinsic
            pts = np.stack([(xs - k[0, 2]) / k[0, 0] * z,
                            (ys - k[1, 2]) / k[1, 1] * z, z], axis=1)
            self.samples.append((pts.astype(np.float32),
                                 rgb[ys, xs].astype(np.float32) / 255.0))

        self.seg = segmenter.Segmenter(
            Config(data=spec.config), TOPICS, device,
            forest=load_forest(s.forest_path, class_counts=list(s.class_counts)))
        self.seg.initialize_projector(
            [CAMERA], [Calibration(intrinsic=s.intrinsic, rotation=np.eye(3),
                                   translation=np.zeros(3))], (s.h, s.w))
        self.next_node = 1
        self.next_map = 0
        self.maps: Dict[int, Tuple[int, float]] = {}  # map -> (first node, due)
        self.served: Dict[int, Tuple[float, array.array]] = {}
        for w in range(int(t["warmup_maps"])):
            self.drive(0.0, self.rate if w % 2 else float("inf"), nodes=self.k)
        self.maps.clear()
        self.served.clear()

    def pose(self, node: int) -> np.ndarray:
        p = np.eye(4, dtype=np.float32)
        p[0, 3] = self.step * node
        return p

    def send_node(self) -> int:
        node = self.next_node
        rgb, depth = self.frames[(node - 1) % len(self.frames)]
        self.seg.push_color(CAMERA, node, rgb)
        self.seg.push_depth(CAMERA, node, depth)
        if not self.seg.on_new_node(segmenter.MapNode(node, self.pose(node), [node])):
            raise RuntimeError(f"node {node} was gated out")
        self.next_node += 1
        return node

    def send_map(self, first: int) -> int:
        nodes = range(first, first + self.k)
        pts, cols = zip(*(self.samples[(n - 1) % len(self.frames)] for n in nodes))
        pts = np.concatenate([p + self.pose(n)[:3, 3] for p, n in zip(pts, nodes)])
        map_id = self.next_map
        self.seg.on_new_local_map(segmenter.LocalMapData(
            map_id, [segmenter.MapNode(n, self.pose(n), [n]) for n in nodes],
            pts.astype(np.float32), np.concatenate(cols)))
        self.next_map += 1
        return map_id

    def poll(self, pending: Dict[int, float]) -> None:
        stored = set(self.seg.stored_semantics_ids())
        for map_id in [m for m in pending if m in stored]:
            _, labels = self.seg.get_local_map_segmentation(map_id, self.s.layer_names)
            served_at = time.perf_counter()
            del pending[map_id]
            # Kept compact: hundreds of lists of 60000 ints would lengthen
            # the collector's full passes inside the window.
            self.served[map_id] = (served_at, array.array("i", labels))

    def drive(self, seconds: float, rate: float, nodes: int = None) -> dict:
        """Nodes due at ``rate`` for ``seconds`` (or ``nodes`` of them), a
        map after every ``map_every``-th, then the wait for the maps; -> the
        section's latencies (s, in the order the maps were due) and how late
        each node was sent."""
        pending: Dict[int, float] = {}
        sent: List[int] = []
        late: List[float] = []
        start = time.perf_counter() + 0.005
        i = 0
        while i < nodes if nodes is not None else (i / rate < seconds or i % self.k):
            due = start + i / rate
            while (now := time.perf_counter()) < due:
                if pending:
                    self.poll(pending)
                time.sleep(max(0.0, min(POLL_S, due - time.perf_counter())))
            late.append(now - due)
            node = self.send_node()
            if node % self.k == 0:
                map_id = self.send_map(node - self.k + 1)
                self.maps[map_id] = (node - self.k + 1, due)
                pending[map_id] = due
                sent.append(map_id)
            i += 1
        deadline = time.perf_counter() + GRACE_S
        while pending and time.perf_counter() < deadline:
            self.poll(pending)
            time.sleep(POLL_S)
        end = time.perf_counter()
        lat = [(self.served[m][0] if m in self.served else end) - self.maps[m][1]
               for m in sent]
        return {"latencies": lat, "sent": sent, "unserved": len(pending),
                "nodes": i, "late": late, "seconds": end - start}

    def _summary(self, d: dict) -> dict:
        ms = [1000 * x for x in d["latencies"]]
        late = [1000 * x for x in d["late"]]
        return {"rate_nodes_per_s": self.rate, "nodes": d["nodes"],
                "maps": len(d["sent"]), "unserved": d["unserved"],
                "latency_ms": {"p50": quantile(ms, 50), "p95": quantile(ms, 95),
                               "max": max(ms, default=None)},
                "generator_late_ms": {"p50": quantile(late, 50),
                                      "p95": quantile(late, 95),
                                      "max": max(late, default=None)},
                "seconds": d["seconds"]}

    def window(self, seconds: float) -> dict:
        d = self.drive(seconds, self.rate)
        self.last = d
        return {"metrics": {"map_latency_p95_ms": quantile(
                    [1000 * x for x in d["latencies"]], 95)},
                "keyframes": d["nodes"], "attempted": len(d["sent"]), "failed": d["unserved"],
                "info": self._summary(d)}

    def traced(self) -> TracedRun:
        from torch.profiler import profile

        walls, sections = [], []
        for prof in (None, profile(activities=activities(self.dev))):
            sync(self.dev)
            launches0 = forest_cuda.launches.value
            with prof or contextlib.nullcontext():
                t0 = time.perf_counter()
                sections.append(self.drive(self.trace_seconds, self.rate))
                sync(self.dev)
                walls.append(time.perf_counter() - t0)
        plain, d = sections
        self.last = d
        return TracedRun(Trace.from_profile(prof, walls[1]), d["nodes"], len(d["sent"]),
                         {"attempted": len(plain["sent"]) + len(d["sent"]),
                          "failed": plain["unserved"] + d["unserved"],
                          "info": dict(self._summary(d), untraced=self._summary(plain))},
                         walls[0],
                         counters={"forest_descent_launches":
                                   forest_cuda.launches.value - launches0})

    def least_s(self) -> Dict[str, float]:
        """No metric of this cell divides by a least time."""
        return {}

    def release(self) -> None:
        self.seg.stop()
        del self.seg
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

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
        worst = 0.0
        for map_id in sorted(sample):
            first, _ = self.maps[map_id]
            nodes = list(range(first, first + self.k))
            pts = np.concatenate([self.samples[(n - 1) % len(self.frames)][0]
                                  + self.pose(n)[:3, 3] for n in nodes]).astype(np.float32)
            cols = np.concatenate([self.samples[(n - 1) % len(self.frames)][1]
                                   for n in nodes])
            labels = {}
            for dt in ((torch.float32, torch.bfloat16) if control else (torch.float32,)):
                posts = [(self.pose(n), reference_frame(
                    s, *self.frames[(n - 1) % len(self.frames)], self.dev, dt)[0])
                    for n in nodes]
                p = torch.from_numpy(pts).to(self.dev)
                u = ref_fusion.unaries(p, posts, s.intrinsic, np.eye(3), np.zeros(3),
                                       conf["depth_min"], FAR, s.h, s.w, dt)
                if conf["use_dense_crf"]:
                    labels[dt] = ref_lattice.crf_labels(
                        u, p, torch.from_numpy(cols).to(self.dev), conf,
                        s.class_counts, s.unknown_labels)
                else:
                    labels[dt] = ref_fusion.plain_labels(u, s.class_counts,
                                                         s.unknown_labels)
            got = (labels[torch.bfloat16] if control else
                   np.asarray(self.served[map_id][1]).reshape(len(s.class_counts), -1))
            worst = max(worst, mismatch(got, labels[torch.float32]))
        return {"map_label_mismatch": worst, "maps_never_served": d["unserved"]}
