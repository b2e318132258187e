"""Forest training by the published recipe (``semantic_segmentation_train``)
through the train CLI's own path.

One job is what ``cli/train.py`` does after loading its dataset: the
configuration's ``training_images`` VGA images, each brightness-shifted by
-20, 0 and +20 and each shift with and without a horizontal flip, through
``cli.train.extract_training_rows`` (WITH_POSITIVE_LABEL features at
``training_sample_stride``, kernel A on the card), then
``ForestTrainer(TrainerConfig.from_config(conf)).learn`` (the forest's
trees in one level loop, device growth, exact search, the leaves refit). A
keyframe is one training image, so the device time per keyframe is the
card's work per training image; ``attempted`` counts forests and ``failed``
those that raised or have a tree without a split.

The images and their two label layers come from the seed by the recipe of
the fixture forest (``resources/bench_forest.dat``,
``scripts/make_bench_forest.py``), frozen here: ``gen.make_depth``, colour
loosely tied to depth, material from height bands and object from colour
sums, -1 where the depth is missing. Set-up makes the images and runs one
whole job; the window repeats the job.

The traced section runs one job, then the same job under the profiler, then
replays it from this thread with the harness's ``FRAME_SPAN`` around each
image's extraction and ``GROW_SPAN`` around ``learn``. Each window and
traced section records in its ``info`` the port's counters ``train.rows``,
``train.levels`` and ``train.nodes`` over its jobs (not the replay's);
``null`` where the program has no such counter.

``check`` holds the last job's rows and forest to the plain reference
(``reference/train.py``): tree ``seed mod 4`` grown by the reference on the
job's own rows, node for node, and two images drawn from the seed, all 6
variants each, extracted by the reference, row for row.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

# Imported when the cell is built: a program without this function fails at
# once on this cell.
from rovinasemanticsegmentation_tpu_torch.cli.train import extract_training_rows
from rovinasemanticsegmentation_tpu_torch.device import resolve_device
from rovinasemanticsegmentation_tpu_torch.features.dataset import (
    DatasetSample, layer_prefixes_for)
from rovinasemanticsegmentation_tpu_torch.features.extractor import (
    FeatureConfig, FeatureExtractor)
from rovinasemanticsegmentation_tpu_torch.train.forest_trainer import (
    ForestTrainer, TrainerConfig)
from rovinasemanticsegmentation_tpu_torch.utils import profiling
from rovinasemanticsegmentation_tpu_torch.utils.calibration import Calibration
from rovinasemanticsegmentation_tpu_torch.utils.config import Config

from port_bench import gen, roofline
from port_bench.common import Setting
from port_bench.drivers.stream import FRAME_SPAN
from port_bench.reference import train as ref_train
from port_bench.trace import Trace, TracedRun, activities, sync

GROW_SPAN = "port_bench: forest growth"
# The seed of the forest's streams: the train CLI's (TrainerConfig.from_config).
FOREST_SEED = 0
COUNTERS = ("train.rows", "train.levels", "train.nodes")
# A row's depth, height and normal angle may differ from the reference's by
# this much (m, m, rad). Every row of a job came out bit-equal on the card
# and on the CPU; the tolerance leaves room for the last float32 bits of an
# angle (the card sums the normals' float64 prefixes in another order than
# the reference's cumsum, ~1e-7 rad) or of a height (a multiply-add rounded
# once, ~1e-6 m at 15 m), while bfloat16 moves the depth by up to 2^-9 of
# it, 1 mm at 0.5 m. The patch bytes and labels are compared exactly.
TAIL_TOLERANCE = 1e-5


def counts() -> Dict[str, Optional[int]]:
    """The port's counters of this cell; None for one the program lacks (the
    port makes each when its module is imported)."""
    made = getattr(profiling, "_counters", {})
    return {n: (made[n].value if n in made else None) for n in COUNTERS}


def make_rgb(r: np.random.Generator, depth: np.ndarray) -> np.ndarray:
    """Colour loosely tied to the depth (smooth, with patches)."""
    h, w = depth.shape
    base = (depth.astype(np.float32) / 15500.0 * 200.0)[..., None]
    rgb = base + r.normal(0, 20, (h, w, 3))
    for _ in range(8):
        y0, x0 = r.integers(0, h - h // 8), r.integers(0, w - w // 8)
        bh, bw = r.integers(h // 12, h // 3), r.integers(3 * w // 32, 5 * w // 16)
        rgb[y0 : y0 + bh, x0 : x0 + bw] += r.uniform(-80, 80, 3)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def frame_labels(rgb: np.ndarray, depth: np.ndarray) -> List[np.ndarray]:
    """Material (8 classes) from height bands, object (9) from colour sums;
    -1 where the depth is missing."""
    h = depth.shape[0]
    z = depth.astype(np.float32) / 1000.0
    ys = np.mgrid[0:h, 0 : depth.shape[1]][0]
    height = (ys.astype(np.float32) / h) * z
    mat = np.clip((height / 6.0 * 8.0).astype(np.int64), 0, 7)
    obj = np.clip((rgb.astype(np.int64).sum(-1) // 96), 0, 8)
    mat[depth == 0] = -1
    obj[depth == 0] = -1
    return [mat.astype(np.int8), obj.astype(np.int8)]


def make_images(seed: int, n: int, h: int, w: int):
    """``n`` images (rgb uint8 [H, W, 3], depth uint16 mm [H, W], labels [2 x
    int8 [H, W]]) drawn from one generator."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        depth = gen.make_depth(rng, h, w)
        rgb = make_rgb(rng, depth)
        out.append((rgb, depth, frame_labels(rgb, depth)))
    return out


class Cell:
    def __init__(self, spec, seed: int, device: str):
        self.s = s = Setting(spec.config, spec.root)
        conf = Config(data=spec.config)
        self.seed = seed
        self.dev = resolve_device(device)
        self.stride = conf.get_int("training_sample_stride")
        self.n_images = conf.get_int("training_images")
        self.check_images = int(spec.traffic["check_images"])
        self.calib = Calibration(intrinsic=s.intrinsic, rotation=np.eye(3),
                                 translation=np.zeros(3))
        self.images = make_images(seed, self.n_images, s.h, s.w)
        self.samples = [DatasetSample(f"image{i}", rgb, depth, self.calib, labels)
                        for i, (rgb, depth, labels) in enumerate(self.images)]
        self.extractor = FeatureExtractor(FeatureConfig.from_config(conf), self.dev)
        self.trainer = ForestTrainer(TrainerConfig.from_config(conf), self.dev)
        self.shared = layer_prefixes_for(conf)[1]
        self.last = self.job()

    def learn(self, x, y):
        return self.trainer.learn(x, y, class_counts=list(self.s.class_counts),
                                  multi_label=self.shared, progress=False)

    def job(self):
        """One training job: -> (rows [N, D] on the device, labels [N, L],
        the forest)."""
        x, y = extract_training_rows(self.samples, self.extractor, self.stride)
        return x, y, self.learn(x, y)

    def _jobs(self, seconds: float, tally: dict):
        """Jobs until ``seconds`` have passed: -> (jobs, failed, elapsed)."""
        jobs = failed = 0
        before = counts()
        sync(self.dev)
        t0 = time.perf_counter()
        while jobs == 0 or time.perf_counter() - t0 < seconds:
            self.last = None  # one job's rows on the card at a time
            jobs += 1
            try:
                self.last = self.job()
            except Exception as exc:  # noqa: BLE001 - a forest that raised fails
                failed, error = failed + 1, exc
                traceback.print_exc()
                continue
            failed += int(min(self.last[2].node_counts) < 2)
        if self.last is None:  # the section ends with no forest to check
            raise error
        elapsed = time.perf_counter() - t0
        for n, v in counts().items():
            tally[n] = None if v is None else tally[n] + v - before[n]
        return jobs, failed, elapsed

    def window(self, seconds: float) -> dict:
        tally = dict.fromkeys(COUNTERS, 0)
        jobs, failed, elapsed = self._jobs(seconds, tally)
        images = (jobs - failed) * self.n_images
        return {"metrics": {"keyframes_per_s": images / elapsed},
                "keyframes": images, "attempted": jobs, "failed": failed,
                "info": {"jobs": jobs, "images": images, "rows": len(self.last[0]),
                         "nodes": list(self.last[2].node_counts), "seconds": elapsed,
                         "counters": tally}}

    def replay(self):
        """The job again from this thread through the public entry points,
        one image at a time, with the harness's spans."""
        from torch.profiler import record_function

        parts = []
        for sample in self.samples:
            with record_function(FRAME_SPAN):
                parts.append(extract_training_rows([sample], self.extractor, self.stride))
        x = torch.cat([p[0] for p in parts])
        y = np.concatenate([p[1] for p in parts])
        del parts
        with record_function(GROW_SPAN):
            return self.learn(x, y)

    def traced(self) -> TracedRun:
        from torch.profiler import profile

        acts = activities(self.dev)
        tally = dict.fromkeys(COUNTERS, 0)
        walls, jobs, failed = [], 0, 0
        for prof in (None, profile(activities=acts)):
            with prof or contextlib.nullcontext():
                n, f, wall = self._jobs(0.0, tally)
            walls.append(wall)
            jobs, failed = jobs + n, failed + f
        plain, wall = walls
        real = Trace.from_profile(prof, wall)
        sync(self.dev)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            self.replay()
            replay_wall = time.perf_counter() - t0
        replay = Trace.from_profile(prof, replay_wall, (FRAME_SPAN, GROW_SPAN))
        return TracedRun(real, self.n_images, 0,
                         {"attempted": jobs, "failed": failed,
                          "info": {"jobs": jobs, "seconds": plain, "traced_seconds": wall,
                                   "replay_seconds": replay_wall, "counters": tally}},
                         plain, replay=replay)

    def least_s(self) -> Dict[str, float]:
        """Kernel A's least time per launch, on the stride grids of the
        job's variants (the flipped ones sample other columns)."""
        s, conf = self.s, self.s.conf
        padded = (s.h + 2 * conf["patch_size"]) * (s.w + 2 * conf["patch_size"])
        pb = 3 * conf["patch_size_reduce"] ** 2
        cfg = dataclasses.replace(s.frame_config, stride=self.stride)
        bounds = []
        for rgb, depth, labels in self.images:
            for _, d, _ in ref_train.variants(rgb, depth, labels):
                grid = d[::self.stride, ::self.stride]
                valid = int(ref_train.in_range(d, cfg).sum())
                bounds.append(roofline.patches_bound_s(padded, grid.size, valid, pb))
        return {"patches": float(np.mean(bounds))}

    def release(self) -> None:
        """Frees the port's state; the last job's rows and forest stay."""
        del self.extractor, self.trainer
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> Dict[str, float]:
        """The last job against the reference: ``tree_node_mismatch`` (tree
        ``seed mod 4`` grown by the reference on the job's rows, see
        ``reference/train.py::tree_mismatch``) and ``train_row_mismatch``
        (the share of the sampled images' rows with a patch byte or label
        that differs, or a depth, height or normal angle off by more than
        ``TAIL_TOLERANCE``). With ``control``, the reference on rows rounded
        to bfloat16 stands in for the program."""
        s = self.s
        x, y, forest = self.last
        cfg = dataclasses.replace(s.frame_config, stride=self.stride)
        conf = s.conf
        grow = dict(class_counts=s.class_counts, t=self.seed % conf["num_trees"],
                    seed=FOREST_SEED, max_depth=conf["max_depth"],
                    min_split=conf["min_split_sample"])
        want = ref_train.grow_tree(x, y, **grow)
        if control:
            got = ref_train.grow_tree(x.to(torch.bfloat16).to(torch.float32), y, **grow)
            tree = (got.split, got.threshold, got.left, got.hist)
        else:
            v = forest.tree_view(grow["t"])
            tree = (v.split_feature, v.threshold, v.left_child, v.leaf_hist)
        node_mm = ref_train.tree_mismatch(*tree, want)

        variants = [list(ref_train.variants(*image)) for image in self.images]
        sizes = [int(ref_train.kept(d, l, cfg).sum()) for vs in variants for _, d, l in vs]
        if sum(sizes) != len(x):
            return {"tree_node_mismatch": node_mm, "train_row_mismatch": 1.0}
        offsets = np.cumsum([0] + sizes)
        rng = np.random.default_rng([self.seed, 13])
        pick = rng.choice(self.n_images, size=min(self.check_images, self.n_images),
                          replace=False)
        bad = total = 0
        pb = 3 * s.conf["patch_size_reduce"] ** 2
        for i in sorted(int(p) for p in pick):
            for v, (rgb, d, l) in enumerate(variants[i]):
                args = (rgb, d, l, s.kinv, np.eye(3), np.zeros(3), cfg, self.dev)
                want_x, want_y = ref_train.training_rows(*args)
                if control:
                    got_x, got_y = ref_train.training_rows(*args, dtype=torch.bfloat16)
                else:
                    k = offsets[i * ref_train.VARIANTS + v]
                    got_x, got_y = x[k:k + len(want_x)], y[k:k + len(want_x)]
                tail = (got_x[:, pb:] - want_x[:, pb:]).abs().amax(1) > TAIL_TOLERANCE
                labels = torch.from_numpy((got_y != want_y).any(1)).to(self.dev)
                bad += int(((got_x[:, :pb] != want_x[:, :pb]).any(1) | tail | labels).sum())
                total += len(want_x)
        return {"tree_node_mismatch": node_mm, "train_row_mismatch": bad / max(total, 1)}
