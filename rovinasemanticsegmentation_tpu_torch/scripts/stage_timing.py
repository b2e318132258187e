"""Per-stage timing shared by the stage profilers of the main path.

    profile_slope.py   the frame path (lab+pad, patches, normals, descent, resize)
    profile_normals.py the normals (backproject, change map, chamfer, integral)
    profile_map.py     the map path (fusion, lattice build, mean field, whole)
    exp_lattice.py     the lattice build (embed, dedup, full build)
    exp_filter.py      the neighbour phase's steps and the filter's parts

A stage is a function and the way to make its i-th input: every call's input
is perturbed from its index (never from the index modulo something), so no
two calls of a run see the same input, and stays valid (depth > 0 where it
was, keys that still match). Inputs are made before the timed region, so
only the stage's own work is timed and traced. For each stage, on the card:

(a) the wall slope: K1 calls back to back and one synchronisation, then K2
    calls likewise; ``(T(K2) - T(K1)) / (K2 - K1)``, the median of ``--reps``
    repeats. It is a call's steady-state cost, the host's issue of its
    launches included;
(b) device time, busy time (the union of the device activities' intervals),
    device activities and the top device operations per call, from one
    ``torch.profiler`` window over K1 calls. Every window runs after every
    wall reading of the script, since a profiler window slows the launches
    timed after it in its process;
(c) the idle share, ``1 - busy / wall``.

With ``--device cpu`` (the tests) the kernels' plain versions run, (a) is
the host's wall time and (b) and (c) are None: a CPU run gives no device
metric. Each script prints the card's name and power limit, one JSON line
per stage, then one summary line, and exits 1 if one of its checks failed.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..bench import CRF, Workload, make_workload
from ..device import resolve_device
from ..ops import forest_cuda, patches_cuda
from ..pipelines.local_map import crf_feats
from ..utils.profiling import device_busy_ms

# The vertex slots of the device lattice build: ``LocalMapPipeline``'s
# starting bucket (``pipelines/local_map.py``), which a map of the bench's
# 30000 points fits. A stage whose vertex count exceeds it fails its script.
MAP_BUCKET = 1 << 14
TOP_OPS = 8


@dataclass
class Stage:
    """A timed stage: ``run(*make_input(i))`` is its i-th call. A stage with
    ``fused_into`` set has no work of its own and gets a row of nulls."""

    name: str
    make_input: Optional[Callable[[int], tuple]] = None
    run: Optional[Callable[..., object]] = None
    calls: Tuple[int, int] = (4, 16)  # (K1, K2)
    fused_into: Optional[str] = None


def arguments(description: str) -> argparse.ArgumentParser:
    """The flags every stage profiler takes."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where the kernels' plain "
                         "versions run")
    ap.add_argument("--reps", type=int, default=3,
                    help="repeats of each wall slope (median)")
    return ap


def frame_size(text: str) -> Tuple[int, int]:
    """``"480x640"`` -> (480, 640)."""
    h, w = text.lower().split("x")
    return int(h), int(w)


def start(args) -> torch.device:
    """Resolve the device (raising without a card unless ``--device cpu``)
    and print the card's name and power limit as ``nvidia-smi`` gives them."""
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from . import card_description

        print(card_description(), flush=True)
    else:
        print("cpu: no card; the kernels' plain versions run and every time "
              "is the host's", flush=True)
    return dev


def bench_workload(points: int = 30000, frame: Tuple[int, int] = (480, 640)):
    """The bench's workload at seed 0 (``bench.py::make_workload``): -> (its
    keyframes [(rgb, depth mm)], its map's points [N, 3] and RGB [N, 3])."""
    h, w = frame
    frames, (pts, rgb) = make_workload(
        0, Workload(height=h, width=w, map_points=points))
    return frames, pts, rgb


def map_features(points: int, dev: torch.device) -> torch.Tensor:
    """The CRF features ``[xyz * 0.5 ; rgb * 4]`` of the bench's map."""
    _, pts, rgb = bench_workload(points)
    return crf_feats(torch.from_numpy(pts).to(dev),
                     torch.from_numpy(rgb).to(dev), CRF.xyz_kernel,
                     CRF.rgb_kernel)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Indices:
    """Hands out each stage's input indices, never the same one twice."""

    def __init__(self) -> None:
        self.next = 0

    def take(self, k: int) -> range:
        first, self.next = self.next, self.next + k
        return range(first, first + k)


def _timed_run(stage: Stage, indices: _Indices, k: int,
               dev: torch.device) -> float:
    """Seconds for ``k`` calls on fresh inputs, back to back, then one sync."""
    inputs = [stage.make_input(i) for i in indices.take(k)]
    _sync(dev)
    t0 = time.perf_counter()
    for x in inputs:
        stage.run(*x)
    _sync(dev)
    return time.perf_counter() - t0


def wall_slope(stage: Stage, indices: _Indices, reps: int,
               dev: torch.device) -> List[float]:
    """ms per call by the slope between K1 and K2 calls, one per repeat,
    after one warm-up run of K1 calls."""
    k1, k2 = stage.calls
    _timed_run(stage, indices, k1, dev)
    runs = []
    for _ in range(reps):
        t1 = _timed_run(stage, indices, k1, dev)
        t2 = _timed_run(stage, indices, k2, dev)
        runs.append(1000 * (t2 - t1) / (k2 - k1))
    return runs


def summarize_device(events, calls: int, top: int = TOP_OPS) -> dict:
    """Per call: device ms (the activities' summed durations), busy ms (their
    union), activities, and the top device operations by time with their
    counts, from ``torch.profiler`` events of ``calls`` calls."""
    device = [e for e in events if e.device_type.name != "CPU"]
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for e in device:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "device_ms": sum(v[0] for v in by_name.values()) / 1000 / calls,
        "busy_ms": device_busy_ms(device) / calls,
        "activities": len(device) / calls,
        "top_ops": [{"name": name[:90], "ms": us / 1000 / calls,
                     "count": n / calls} for name, (us, n) in ranked],
    }


def device_profile(stage: Stage, indices: _Indices, dev: torch.device) -> dict:
    """One ``torch.profiler`` window over K1 calls of ``stage``."""
    from torch.profiler import ProfilerActivity, profile

    k1 = stage.calls[0]
    inputs = [stage.make_input(i) for i in indices.take(k1)]
    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for x in inputs:
            stage.run(*x)
        _sync(dev)
    return summarize_device(prof.events(), k1)


def measure(script: str, stages: Sequence[Stage], reps: int,
            dev: torch.device, per: int = 1, unit: str = "call") -> List[dict]:
    """Every stage's wall slope, then (on the card) every stage's profile
    window; numbers per ``unit`` (a call divided by ``per``). Prints and
    returns one line per stage."""
    indices = {s.name: _Indices() for s in stages}
    walls = {s.name: wall_slope(s, indices[s.name], reps, dev)
             for s in stages if s.fused_into is None}
    lines = []
    for s in stages:
        line = {"script": script, "stage": s.name, "unit": unit,
                "device": dev.type, "wall_ms": None, "wall_ms_runs": None,
                "calls": None, "device_ms": None, "busy_ms": None,
                "activities": None, "idle_share": None, "top_ops": None}
        if s.fused_into is not None:
            line["fused_into"] = s.fused_into
        else:
            runs = [ms / per for ms in walls[s.name]]
            line.update(wall_ms=statistics.median(runs), wall_ms_runs=runs,
                        calls=list(s.calls))
            if dev.type == "cuda":
                prof = device_profile(s, indices[s.name], dev)
                for key in ("device_ms", "busy_ms", "activities"):
                    prof[key] /= per
                for op in prof["top_ops"]:
                    op["ms"] /= per
                    op["count"] /= per
                line.update(prof)
                line["idle_share"] = 1 - prof["busy_ms"] / line["wall_ms"]
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def wall(lines: Sequence[dict], name: str) -> float:
    """A printed stage's wall slope."""
    return next(line["wall_ms"] for line in lines if line["stage"] == name)


def finish(script: str, lines: Sequence[dict], checks: Dict[str, bool],
           dev: torch.device, **extra) -> int:
    """Print the summary line -> the exit code: 1 if a check failed or, on
    the card, a timed stage showed no device activity."""
    if dev.type == "cuda":
        checks = dict(checks)
        checks["every timed stage ran on the device"] = all(
            line["activities"] > 0 for line in lines
            if line.get("fused_into") is None)
    ok = all(checks.values())
    print(json.dumps({
        "script": script, "summary": True, "ok": ok, "device": dev.type,
        "checks": checks, "stages": [line["stage"] for line in lines],
        "launches": {"pack_lab": patches_cuda.pack_launches.value,
                     "patches": patches_cuda.launches.value,
                     "forest_descent": forest_cuda.launches.value},
        **extra,
    }), flush=True)
    return 0 if ok else 1


def same(a, b) -> bool:
    """Tensors, or sequences of them, equal in shape, dtype and value."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and bool(torch.equal(a, b)))
    return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
