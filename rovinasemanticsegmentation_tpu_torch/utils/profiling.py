"""Tracing and step timing.

Counterpart of ``rovinasemanticsegmentation_tpu/utils/profiling.py``. The
reference's only instrumentation is ad-hoc ``clock()`` spans printed as "Time
per image" (``test_multi.cpp:170,234,238``) and the forest trainer's
microsecond timer (``learning.cpp:1105``). Here: named step timers with
streaming statistics, and a ``torch.profiler`` trace scope that writes a
Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import torch


@dataclass
class StepStats:
    count: int = 0
    total: float = 0.0
    minimum: float = float("inf")
    maximum: float = 0.0

    def add(self, seconds: float) -> None:
        self.count += 1
        self.total += seconds
        self.minimum = min(self.minimum, seconds)
        self.maximum = max(self.maximum, seconds)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


def _synchronize(out) -> None:
    """Wait for every CUDA device holding a tensor of ``out`` (a tensor, or
    lists, tuples and dicts of them)."""
    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, (list, tuple)):
            for y in x:
                visit(y)
        elif isinstance(x, dict):
            for y in x.values():
                visit(y)

    visit(out)
    for dev in devices:
        torch.cuda.synchronize(dev)


class StepTimer:
    """Named wall-clock spans.

    ``time(..., block=True)`` waits for the CUDA devices of the result's
    tensors inside the span, so the span covers the computation and not only
    its launch.
    """

    def __init__(self) -> None:
        self.stats: Dict[str, StepStats] = defaultdict(StepStats)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            self.stats[name].add(time.perf_counter() - start)

    def time(self, name: str, fn, *args, block: bool = True, **kwargs):
        start = time.perf_counter()
        out = fn(*args, **kwargs)
        if block:
            _synchronize(out)
        self.stats[name].add(time.perf_counter() - start)
        return out

    def report(self) -> str:
        lines = [f"{'step':30s} {'count':>6s} {'mean ms':>9s} {'min':>8s} {'max':>8s}"]
        for name, s in sorted(self.stats.items()):
            lines.append(
                f"{name:30s} {s.count:6d} {s.mean * 1e3:9.2f} "
                f"{s.minimum * 1e3:8.2f} {s.maximum * 1e3:8.2f}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """``torch.profiler`` scope (CPU activities, and CUDA ones where a GPU
    exists) that exports a Chrome trace ``trace.json`` into ``log_dir``; a
    no-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_busy_ms(events) -> float:
    """The union of the intervals of ``torch.profiler`` device activities,
    in ms: the time the device was busy, overlaps counted once."""
    busy_us, edge = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: e.time_range.start):
        lo, hi = max(e.time_range.start, edge), e.time_range.end
        busy_us += max(0.0, hi - lo)
        edge = max(edge, hi)
    return busy_us / 1000
