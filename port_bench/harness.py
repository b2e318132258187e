"""The general part of a run: find a cell's files by name, drive it, read
its metrics, judge it, and print the result.

A cell of ``BENCHMARK.json`` names its configuration (``configs`` gives the
file) and its traffic mix, ``traffic/<traffic>.json``, which names its
driver, ``drivers/<driver>.py``. The limits of the numbers that decide
``correct`` are ``limits/<cell>.json``, and each per-layer metric is read by
``metrics/<metric>.py`` or, where there is none, by the reader of its
quantity (see ``reader``). A driver module defines ``Cell(spec, seed,
device)``, whose construction is the set-up, with ``window(seconds)``,
``traced()``, ``release()``, ``least_s()`` (after a traced section: the
least device times the metric readers divide by, worked out once the
port's state is freed) and ``check(control=False)``. ``window`` returns the
keyframes it finished and its metrics on the host's clock.

A run with ``--trace 0`` measures its window on the device's clock
(``trace.DeviceClock``): ``device_ms_per_keyframe`` is the card's busy time
over the window's keyframes. A run with ``--trace 1`` first runs an
untraced window of ``layer_window_s`` (traffic file; else ``--seconds``),
whose host-clock numbers its per-layer metrics read, then the driver's
traced section.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from port_bench.trace import DeviceClock

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# Compared whole with each loaded module's top-level name: the port's own
# name begins with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "rovinasemanticsegmentation_tpu")


@dataclass
class Spec:
    """One cell's entries and files."""

    bench: dict  # BENCHMARK.json
    cell: dict  # its entry under "workloads"
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    limits: dict  # limits/<cell>.json
    root: str = ROOT


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(workload: str, root: str = ROOT) -> Spec:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; "
                         f"cells: {sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    here = os.path.join(root, "port_bench")
    return Spec(bench, cell, _json(os.path.join(root, config["file"])),
                _json(os.path.join(here, "traffic", cell["traffic"] + ".json")),
                _json(os.path.join(here, "limits", workload + ".json")), root)


def load_module(kind: str, name: str):
    """``port_bench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    mod_name = f"port_bench.{kind}.{name.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


def reader(metric: str):
    """The reader of a per-layer metric: ``metrics/<metric>.py``, or where
    there is none, that of its quantity, the name before the first dot, so
    that one quantity read in several kinds of cell has one reader."""
    own = os.path.isfile(os.path.join(BENCH_DIR, "metrics", metric + ".py"))
    return load_module("metrics", metric if own else metric.split(".")[0])


def set_cache_dirs() -> None:
    """Every build and kernel cache that PyTorch may use, at fixed paths
    inside the checkout (the port's own CUDA and g++ libraries build into
    its ``csrc/_build``); no library may load JAX behind the port's back."""
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", os.path.join(cache, "inductor"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> List[str]:
    return sorted(n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN)


def reported(spec: Spec, trace: bool) -> List[dict]:
    """The metrics this cell reports in a run: its end-to-end ones, or with
    ``trace`` its per-layer ones."""
    name = spec.cell["name"]
    e2e = [m for m in spec.bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moves = {m["name"] for m in e2e}
    return [m for m in spec.bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in moves)]


def measure(spec: Spec, seed: int, seconds: float, trace: bool, device: str,
            t_start: float) -> Tuple[dict, Dict[str, dict]]:
    """Set up, drive, read, free, judge: -> (result without ``checks``, the
    checks)."""
    import torch

    on_card = device == "cuda"
    driver = load_module("drivers", spec.traffic["driver"])
    cell = driver.Cell(spec, seed, device)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    metrics: Dict[str, dict] = {}
    extra: Dict[str, object] = {}
    phases = {"setup_s": setup_s}
    t = time.perf_counter()
    if trace:
        window = cell.window(float(spec.traffic.get("layer_window_s", seconds)))
        print(json.dumps({"window": dict(window["info"], **window["metrics"])}), flush=True)
        data = cell.traced()
        data.window = window
        run = dict(data.run, attempted=data.run["attempted"] + window["attempted"],
                   failed=data.run["failed"] + window["failed"])
    else:
        with DeviceClock(cell.dev) as clock:
            run = cell.window(seconds)
        run["metrics"]["device_ms_per_keyframe"] = 1000.0 * clock.busy_s / run["keyframes"]
        run["info"].update(run["metrics"], device_activities=clock.activities)
    print(json.dumps({"window": run["info"]}), flush=True)
    phases["window_and_trace_s"] = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    cell.release()
    breakdown = None
    if trace:
        # The yardstick's own work (the reference's reads) runs after the
        # peak was read and the port's state was freed.
        data.least_s = cell.least_s()
        for m in reported(spec, True):
            value = reader(m["name"]).read(data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra["busy_s"] = data.real.busy_s
        extra["window_s"] = data.real.wall_s
        breakdown = data.real.breakdown()
    else:
        values = dict(run["metrics"], setup_s=setup_s)
        for m in reported(spec, False):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    t = time.perf_counter()
    numbers = cell.check()
    phases["check_s"] = time.perf_counter() - t
    print(json.dumps({"phases": phases}), flush=True)
    checks = {k: {"value": v, "limit": spec.limits[k]} for k, v in numbers.items()}
    device_info = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": int(spec.cell["chips"]),
        "memory_peak_bytes": int(peak),
        **extra,
    }
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": int(run["attempted"]),
        "failed": int(run["failed"]),
        "metrics": metrics,
        "device": device_info,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    return result, checks


def emit(result: dict, checks: Dict[str, dict]) -> None:
    """The checks as the last lines of standard error, then the result, with
    the checks as its last key, as the last line of standard output."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(dict(result, checks=checks)), flush=True)


def quantile(values: List[float], q: int, n: int = 100) -> Optional[float]:
    """The ``q``-th of ``n`` quantiles (``statistics.quantiles``, inclusive);
    None without values, the one value when there is one."""
    import statistics

    if not values:
        return None
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=n, method="inclusive")[q - 1])
