"""Wall time of the 2D dense-CRF demo, ``cli/dense_inference.py``, per image.

The counterpart of ``scripts/bench_dense_inference.py``. It times the
port's ``cli.dense_inference.run`` end to end, the reference's span: load
-> unary -> CRF set-up with its lattice build -> mean field -> colorize ->
save, for both builds (``False``: the native host builder and
``DenseCRF2D``, timed first as in the JAX script; ``True``: both lattices
on the device). Per image, its first run and the best of ``--reps`` warm
runs; per build, the first image's first run as its cold time.

Usage:

    python -m rovinasemanticsegmentation_tpu_torch.scripts.bench_dense_inference \\
        [--device cuda|cpu] [--reps 3] [--height 240] [--width 320]
        [--examples DIR]

Inputs: the densecrf example's three PPM pairs are not in the repository,
so three inputs of the demo's shape (320x240, 21 labels, half of the
annotation unknown) are made from seeds 1-3 by :func:`make_demo_pair`.
With ``--examples DIR`` holding ``im{i}.ppm`` and ``anno{i}.ppm``, those
are timed instead and each output is checked against
``tests/golden/out{i}_ref.ppm``; otherwise the golden check is "skipped".

On the card it then profiles one image per build, each in a spawned process
of its own (a ``torch.profiler`` window slows the launches after it in its
process): device busy ms, the device's idle share, device activities per
image and the top device activities and operators.

Prints the card's name and power limit, then one JSON line
``{"metric": "dense_inference_ms_per_image", ...}``. Its ``value`` is the
JAX script's: the worst image's warm time of the faster build, among the
builds whose outputs equal the goldens; with no golden check ("skipped")
both builds are candidates, and where the check ran and no build passed,
``value`` is left out. On the card by default; without one, ``--device
cuda`` raises.

Left out of the JAX script, as TPU run machinery: ``tpu_lock``; the
``TUNING.json`` record of the faster build; the recolouring of one
annotation pixel per warm run (the TPU runtime memoized identical
executions, and the port caches nothing keyed on its inputs); and the
``reference_ms`` / ``vs_baseline`` fields, whose times are a CPU binary's on
the example images.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import tempfile
import time
from collections import defaultdict
from typing import List, Optional

import numpy as np
import torch

from ..cli import dense_inference
from ..device import resolve_device
from ..utils.imageio import load_ppm, save_ppm

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "golden")
SEEDS = (1, 2, 3)
BUILDS = {"host": False, "device": True}


def make_demo_pair(rng: np.random.Generator, h: int, w: int,
                   labels: int = dense_inference.M):
    """A dense_inference input: an image of noisy piecewise-constant colour
    regions (Voronoi cells of 24 seeds) and its annotation, each region in
    one of ``labels`` colours, half of the pixels unknown (black)."""
    ys, xs = np.mgrid[0:h, 0:w]
    seeds = rng.uniform([0, 0], [h, w], (24, 2))
    region = np.argmin((ys[..., None] - seeds[:, 0]) ** 2
                       + (xs[..., None] - seeds[:, 1]) ** 2, axis=-1)
    region_label = np.concatenate([np.arange(labels),
                                   rng.integers(0, labels, 24 - labels)])
    colours = rng.integers(30, 226, (24, 3))
    im = colours[region] + rng.normal(0, 12, (h, w, 3))
    i = np.arange(labels)[:, None]
    palette = np.concatenate([(i * 37 + 20) % 256, (i * 91 + 40) % 256,
                              (i * 53 + 60) % 256], axis=1)
    anno = palette[region_label[region]]
    anno[rng.random((h, w)) < 0.5] = 0
    return (np.clip(im, 0, 255).astype(np.uint8), anno.astype(np.uint8))


def write_inputs(root: str, h: int, w: int) -> List[tuple]:
    """The three seeded inputs as PPMs in ``root`` -> [(image, annotation)]."""
    out = []
    for i in SEEDS:
        im, anno = make_demo_pair(np.random.default_rng(i), h, w)
        paths = (f"{root}/im{i}.ppm", f"{root}/anno{i}.ppm")
        save_ppm(paths[0], im)
        save_ppm(paths[1], anno)
        out.append(paths)
    return out


def one_run(paths, out_path: str, device_build: bool, dev) -> float:
    """ms of one ``dense_inference.run``, the device synchronised."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense_inference.run(*paths, out_path, device_build=device_build, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return 1000 * (time.perf_counter() - t0)


def measure_build(pairs, root: str, device_build: bool, reps: int, dev,
                  golden: bool) -> dict:
    """Per image: its first run, the best of ``reps`` warm runs and, with
    ``golden``, whether the first output equals the golden PPM."""
    out = {}
    for i, paths in zip(SEEDS, pairs):
        dst = f"{root}/out{i}.ppm"
        first = one_run(paths, dst, device_build, dev)
        same = None
        if golden:
            same = bool(np.array_equal(
                load_ppm(dst), load_ppm(f"{GOLDEN}/out{i}_ref.ppm")))
        warm = min(one_run(paths, dst, device_build, dev) for _ in range(reps))
        out[f"im{i}"] = {"first_ms": first, "warm_ms": warm, "golden": same}
    return out


def profile_image(device_build: bool, h: int, w: int, top: int = 10) -> dict:
    """One image (seed 1) through ``dense_inference.run`` on the card under
    ``torch.profiler``, after one unprofiled run; runs in a spawned
    process of its own."""
    from torch.profiler import ProfilerActivity, profile

    from ..utils.profiling import device_busy_ms

    dev = resolve_device("cuda")
    with tempfile.TemporaryDirectory() as root:
        paths = write_inputs(root, h, w)[0]
        one_run(paths, f"{root}/out.ppm", device_build, dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall_ms = one_run(paths, f"{root}/out.ppm", device_build, dev)
    device = [e for e in prof.events() if e.device_type.name != "CPU"]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in device:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    busy = device_busy_ms(device)
    ops = sorted(((e.key, e.device_time_total, e.count)
                  for e in prof.key_averages()
                  if e.device_time_total > 0 and e.key.startswith("aten::")),
                 key=lambda r: -r[1])[:top]
    return {
        "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy,
        "device_ms": sum(v[0] for v in by_name.values()) / 1000,
        "device_idle_share": 1 - busy / wall_ms,
        "device_activities": len(device),
        "top_device_activities": [
            {"name": name[:120], "ms": us / 1000, "count": n}
            for name, (us, n) in sorted(by_name.items(),
                                        key=lambda kv: -kv[1][0])[:top]],
        "top_ops": [{"op": k, "device_ms": t / 1000, "calls": n}
                    for k, t, n in ops],
    }


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--reps", type=int, default=3, help="warm runs per image")
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--examples", default=None,
                    help="a directory with the densecrf example's "
                         "im{1,2,3}.ppm and anno{1,2,3}.ppm")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    h, w = args.height, args.width
    golden = args.examples is not None and all(
        os.path.exists(f"{args.examples}/{p}{i}.ppm")
        for i in SEEDS for p in ("im", "anno"))
    with tempfile.TemporaryDirectory() as root:
        if golden:
            pairs = [(f"{args.examples}/im{i}.ppm", f"{args.examples}/anno{i}.ppm")
                     for i in SEEDS]
            h, w = load_ppm(pairs[0][0]).shape[:2]
        else:
            pairs = write_inputs(root, h, w)
        per_build = {name: measure_build(pairs, root, build, args.reps, dev,
                                         golden)
                     for name, build in BUILDS.items()}
    profiles = None
    if dev.type == "cuda":
        ctx = multiprocessing.get_context("spawn")
        profiles = {}
        for name, build in BUILDS.items():
            with ctx.Pool(1) as pool:
                profiles[name] = pool.apply(profile_image, (build, h, w))
        from . import card_description

        card = card_description()
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": torch.cuda.device_count(),
                  "name_and_power_limit": card}
        print(card)
        for name, p in profiles.items():
            print(f"{name} build, one image: {p['profiled_wall_ms']:.3f} ms "
                  f"wall, device busy {p['device_busy_ms']:.3f} ms "
                  f"(idle {p['device_idle_share']:.1%}), "
                  f"{p['device_activities']} device activities")
    else:
        device = {"platform": "cpu", "kind": "cpu", "count": 1,
                  "name_and_power_limit": None}
    parity = ({name: all(r["golden"] for r in res.values())
               for name, res in per_build.items()} if golden else "skipped")
    worst = {name: max(r["warm_ms"] for r in res.values())
             for name, res in per_build.items()
             if not golden or parity[name]}
    out = {
        "metric": "dense_inference_ms_per_image",
        "unit": f"ms (best of {args.reps} warm, the whole run: IO, "
                "unary, lattice build, mean field, colorize)",
        "inputs": ("examples" if golden
                   else f"make_demo_pair, seeds {list(SEEDS)}"),
        "height": h,
        "width": w,
        "labels": dense_inference.M,
        "per_image": per_build,
        "cold_first_ms": {name: res["im1"]["first_ms"]
                          for name, res in per_build.items()},
        "golden": parity,
        "profile": profiles,
        "device": device,
    }
    if worst:
        faster = min(worst, key=worst.get)
        out["value"] = worst[faster]
        out["device_build_wins"] = BUILDS[faster]
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
