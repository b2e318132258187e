"""Reduction of a ``torch.profiler`` window to what the metrics read.

``DeviceClock`` takes the card's busy time over a whole measured window, for
the end-to-end metric on the device's clock.

A traced window keeps, as plain tuples, the device activities (kernels,
copies, sets), the device-side ranges of the harness's own spans
(``record_function`` around calls into the port; other annotations are
dropped) and the host's operations.
``busy_s`` is the union of the device intervals (the port's
``utils/profiling.py::device_busy_ms``, copied); an activity belongs to the
span whose device-side range holds its start; an idle gap of the device is
charged to the innermost host operation running at its middle.
"""

from __future__ import annotations

import bisect
import heapq
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[str, float, float]  # (name, start us, end us)


def activities(device):
    """What ``torch.profiler`` records on ``device``: the host's operations,
    and the card's activities on a CUDA device."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


def sync(device) -> None:
    """Wait for ``device``'s queued work (nothing to wait for on the CPU)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


NAME_CHARS = 120  # names in a breakdown are cut to this many characters


@dataclass
class Trace:
    """One profiler window: device activities, span ranges, host ops."""

    device: List[Interval]
    spans: List[Interval] = field(default_factory=list)
    host: List[Interval] = field(default_factory=list)
    wall_s: float = 0.0  # the host's clock over the window

    @classmethod
    def from_profile(cls, prof, wall_s: float, span_names: Sequence[str] = ()):
        """Split a ``torch.profiler`` window into device activities, span
        ranges on the device, and host operations (see ``from_events``),
        read from the profiler's results as they come, without its
        per-event Python objects."""
        from torch.autograd import DeviceType

        events = [(e.name(), e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3,
                   e.device_type() == DeviceType.CPU, e.is_user_annotation())
                  for e in prof.profiler.kineto_results.events()]
        return cls.from_events(events, wall_s, span_names)

    @classmethod
    def from_events(cls, events, wall_s: float, span_names: Sequence[str] = ()):
        """From (name, start us, end us, on the host, annotation) tuples.

        A ``record_function`` range appears on the device too, as a user
        annotation: it is no activity of the device. The harness's own
        spans (``span_names``) are kept as ranges; any other annotation,
        such as a span inside the port, is dropped, so that spans added to
        the program move neither the activities nor the busy time.
        """
        annotations = {n for n, _, _, host, note in events if host and note}
        names = set(span_names)
        device, spans, host = [], [], []
        for name, start, end, on_host, note in events:
            item = (name, start, end)
            if on_host:
                host.append(item)
            elif name in names:
                spans.append(item)
            elif not (note or name in annotations):
                device.append(item)
        return cls(device, spans, host, wall_s)

    @property
    def busy_s(self) -> float:
        return busy_us(self.device) / 1e6

    def count(self, substring: str) -> Tuple[int, float]:
        """(launches, device seconds) of the activities whose name holds
        ``substring``."""
        hits = [(e - s) for n, s, e in self.device if substring in n]
        return len(hits), sum(hits) / 1e6

    def span_totals(self) -> Dict[str, Tuple[float, int]]:
        """Per span: (device seconds, activities) of the activities that
        start inside one of its device-side ranges."""
        ranges = sorted((s, e, n) for n, s, e in self.spans)
        out: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
        starts = [r[0] for r in ranges]
        for name, s, e in self.device:
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s < ranges[i][1]:
                out[ranges[i][2]][0] += (e - s) / 1e6
                out[ranges[i][2]][1] += 1
        return {k: (v[0], int(v[1])) for k, v in out.items()}

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the longest idle
        gaps summed by what the host was doing, each at most ``top``."""
        ops: Dict[str, float] = defaultdict(float)
        for name, s, e in self.device:
            ops[name[:NAME_CHARS]] += (e - s) / 1e6
        gaps: Dict[str, float] = defaultdict(float)
        for owner, length in _gaps(self.device, self.host):
            gaps[owner] += length
        order = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in order],
                "idle_gaps": [[k, v] for k, v in idle]}


def busy_us(device: Iterable[Interval]) -> float:
    """The union of the intervals, in us: overlaps counted once."""
    items = list(device)
    return union([s for _, s, _ in items], [e for _, _, e in items])


def union(starts, ends) -> float:
    """The length of the union of the intervals [start, end), in their unit:
    overlaps counted once. Whole numbers (ns) stay exact."""
    import numpy as np

    s, e = np.asarray(starts), np.asarray(ends)
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    covered = np.concatenate([s[:1], np.maximum.accumulate(e)[:-1]])
    return float(np.maximum(0, e - np.maximum(s, covered)).sum())


def _gaps(device: Sequence[Interval], host: Sequence[Interval]):
    """Yield (host operation, gap seconds) for every gap between the union
    of device intervals, inside the window the events span; the operation
    is the shortest host event that holds the gap's middle."""
    if not device:
        return
    events = sorted(host, key=lambda x: x[1])
    lo = min([s for _, s, _ in events] + [s for _, s, _ in device])
    hi = max([e for _, _, e in events] + [e for _, _, e in device])
    gaps, edge = [], lo
    for _, s, e in sorted(device, key=lambda x: x[1]):
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    if hi > edge:
        gaps.append((edge, hi))
    heap: List[Tuple[float, float, str]] = []
    i = 0
    for g0, g1 in gaps:  # sorted by start, so by middle
        mid = 0.5 * (g0 + g1)
        while i < len(events) and events[i][1] <= mid:
            name, s, e = events[i]
            heapq.heappush(heap, (e - s, e, name))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        owner = heap[0][2][:NAME_CHARS] if heap else "no host operation recorded"
        yield owner, (g1 - g0) / 1e6


class DeviceClock:
    """The card's busy time over a section: ``with DeviceClock(device) as
    clock: ...`` leaves ``clock.busy_s`` and ``clock.activities``.

    A profiler records the card's activities only (kernels, copies, sets,
    through CUPTI), and they are read from its results as they come, without
    the profiler's per-event Python objects, so that a window of some
    hundred thousand launches is read in seconds. A ``record_function``
    range, which the profiler also puts on the device, is no activity and
    is left out, so that spans added inside the port move nothing. On the
    CPU, where the tests drive the harness, the process's CPU time (all its
    threads) stands in.
    """

    def __init__(self, device):
        self.device = device
        self.busy_s = 0.0
        self.activities = 0

    def __enter__(self):
        import time

        from torch.profiler import ProfilerActivity, profile

        self.prof = None
        self.cpu0 = time.process_time()
        if self.device.type == "cuda":
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        import time

        if self.prof is None:
            self.busy_s = time.process_time() - self.cpu0
            return False
        self.prof.__exit__(*exc)
        if exc[0] is None:
            from torch.autograd import DeviceType

            spans = [(e.start_ns(), e.duration_ns())
                     for e in self.prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
            self.activities = len(spans)
            self.busy_s = union([s for s, _ in spans], [s + d for s, d in spans]) / 1e9
        self.prof = None
        return False


@dataclass
class TracedRun:
    """What a driver's traced section leaves for the metric readers."""

    real: Trace  # the cell's own path under the profiler
    keyframes: int  # keyframes that finished inside ``real``
    maps: int  # maps that finished inside ``real``
    run: dict  # attempted, failed and the section's details
    # The same section run just before without the profiler, which slows
    # the host's issue by about 2x: the wall that idle and peak shares
    # divide by.
    wall_s: float
    replay: Optional[Trace] = None  # the same work, one thread, with spans
    counters: Dict[str, int] = field(default_factory=dict)  # the port's
    least_s: Dict[str, float] = field(default_factory=dict)  # per launch / step
    # The untraced window run before the traced section: what the per-layer
    # metrics on the host's clock read.
    window: dict = field(default_factory=dict)

    def idle_share(self) -> Optional[float]:
        """1 - (device busy under the profiler) / (the section's wall
        without it), or None when nothing ran on the device."""
        if not self.real.device or self.wall_s <= 0:
            return None
        return 1.0 - self.real.busy_s / self.wall_s
