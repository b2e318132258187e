"""The port's tracer: spans and counters, step timing, and the trace export.

Counterpart of ``rovinasemanticsegmentation_tpu/utils/profiling.py``. The
reference's only instrumentation is ad-hoc ``clock()`` spans printed as "Time
per image" (``test_multi.cpp:170,234,238``) and the forest trainer's
microsecond timer (``learning.cpp:1105``).

One tracer per process:

- **Spans.** ``span(name, request)`` records a name, a start and an end, the
  thread that opened it, its parent span, the request it serves (a
  keyframe's node id, a map's id; by default its parent's) and, where the
  caller gives them, named ``attrs`` (a frame batch's cameras). Used as ``with
  span(...)``, it is the parent of the spans opened inside it on that thread.
  A span handed to another thread is ended there with ``end()``, or entered
  there with ``with``, so that the spans opened inside are its children.
  Spans are kept in memory until ``take()`` hands them over.
- **Tracing is off by default**, and switched only by ``tracing(True)`` or
  ``tracing(False)``, either as a call or as a ``with`` block. While it is
  off, ``span`` checks one flag and returns a shared no-op: it reads no
  clock, allocates nothing and records nothing.
- **One clock with the device trace.** Spans are stamped in ns by ``clock``,
  ``time.time_ns``: the clock of ``torch.profiler``'s events
  (``kineto_results.events()``' ``start_ns()``), which the profiler takes
  from its approximate clock converted to Unix time. An idle gap of the card
  in a profile can so be put down to the span open at that moment on any
  thread, also on threads the profiler does not record (it records only the
  thread that started it).
- **Counters** (``counter(name)``): counts kept under a name whatever the
  state of tracing, such as the CUDA wrappers' kernel launches.
- ``StepTimer``: named spans with streaming statistics, a view of the tracer.
- ``device_trace``: the operator's Chrome trace of a block, the tracer's spans
  written into it on the profiler's clock.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

clock = time.time_ns  # the profiler's clock, in ns since the Unix epoch

_on = False  # tracing on; switched by ``tracing`` alone
_lock = threading.Lock()
_spans: list = []  # recorded spans, as tuples of ``Span``'s fields
_ids = itertools.count(1)
_local = threading.local()  # per thread: the spans entered with ``with``
_thread_names: Dict[int, str] = {}  # native id -> name, of threads with spans


class Span(NamedTuple):
    """One recorded span; times in ns on ``clock``."""

    name: str
    start_ns: int
    end_ns: int
    thread: int  # native id of the thread that opened it
    parent: Optional[int]  # the parent's ``id``
    request: Any  # node id, map id, or a list of them
    id: int
    attrs: Optional[dict] = None  # the caller's named values, if any


class tracing:
    """Switch tracing on (``tracing(True)``) or off (``tracing(False)``) now;
    as ``with tracing(...):``, the state before it returns after the block."""

    def __init__(self, on: bool = True) -> None:
        global _on
        self.before = _on
        _on = bool(on)

    def __enter__(self) -> "tracing":
        return self

    def __exit__(self, *exc) -> bool:
        global _on
        _on = self.before
        return False


class _Off:
    """The shared span of tracing off: records nothing."""

    __slots__ = ()
    id = request = attrs = None

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def end(self) -> None:
        pass


_OFF = _Off()


def _thread() -> Tuple[int, list]:
    """This thread's native id, and its spans entered with ``with``."""
    try:
        return _local.tid, _local.stack
    except AttributeError:
        _local.tid, _local.stack = threading.get_native_id(), []
        _thread_names[_local.tid] = threading.current_thread().name
        return _local.tid, _local.stack


class _Open:
    """A span being recorded: ``end()`` records it, as does leaving it as a
    ``with`` block. With ``parts`` > 1 the span ends at the last of that
    many ``end()`` calls, from whichever threads make them."""

    __slots__ = ("name", "start_ns", "thread", "parent", "request", "id",
                 "parts", "attrs")

    def __init__(self, name, request, parent, parts, attrs):
        self.start_ns = clock()
        self.thread, stack = _thread()
        if parent is None and stack:
            parent = stack[-1]
        self.name = name
        self.parent = parent.id if parent is not None else None
        self.request = (request if request is not None or parent is None
                        else parent.request)
        self.id = next(_ids)
        self.parts = parts
        self.attrs = attrs

    def __enter__(self) -> "_Open":
        _thread()[1].append(self)
        return self

    def __exit__(self, *exc) -> bool:
        stack = _thread()[1]
        if stack and stack[-1] is self:
            stack.pop()
        self.end()
        return False

    def end(self) -> None:
        end_ns = clock()
        if self.parts > 1:
            with _lock:
                self.parts -= 1
                if self.parts:
                    return
        # A plain tuple (``take`` makes it a ``Span``); ``list.append`` is
        # atomic, and ``take`` removes only what it copied.
        _spans.append((self.name, self.start_ns, end_ns, self.thread,
                       self.parent, self.request, self.id, self.attrs))


def span(name: str, request: Any = None, parent=None, parts: int = 1,
         attrs: Optional[dict] = None):
    """A span named ``name`` serving ``request`` (default: its parent's),
    child of ``parent`` (default: the innermost span entered with ``with``
    on this thread), with the named values ``attrs``; the shared no-op
    while tracing is off."""
    if not _on:
        return _OFF
    return _Open(name, request, parent, parts, attrs)


def take() -> List[Span]:
    """The spans recorded so far, in the order they ended; the tracer keeps
    none of them."""
    with _lock:
        n = len(_spans)
        out = _spans[:n]
        del _spans[:n]
    return [Span(*s) for s in out]


def self_ns(spans: List[Span]) -> Dict[int, int]:
    """Per span id: its duration less the part of it that its children
    cover (children clipped to it, overlaps counted once)."""
    children: Dict[int, List[Span]] = defaultdict(list)
    for s in spans:
        if s.parent is not None:
            children[s.parent].append(s)
    out = {}
    for s in spans:
        covered, edge = 0, s.start_ns
        for c in sorted(children[s.id], key=lambda c: c.start_ns):
            lo, hi = max(c.start_ns, edge), min(c.end_ns, s.end_ns)
            if hi > lo:
                covered += hi - lo
                edge = hi
        out[s.id] = s.end_ns - s.start_ns - covered
    return out


class Counter:
    """A count the tracer keeps under its name, tracing on or off."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._n = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._n += n

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n


_counters: Dict[str, Counter] = {}


def counter(name: str) -> Counter:
    """The process's counter named ``name`` (made at its first use)."""
    with _lock:
        return _counters.setdefault(name, Counter(name))


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
    """Named spans with per-name statistics: each is a tracer span (recorded
    while tracing is on) whose duration on ``clock`` the timer always adds
    to ``stats``.

    ``time(..., block=True)`` waits for the CUDA devices of the result's
    tensors inside the span, so the span covers the computation and not only
    its launch.
    """

    def __init__(self) -> None:
        self.stats: Dict[str, StepStats] = defaultdict(StepStats)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        start = clock()
        try:
            with span(name):
                yield
        finally:
            self.stats[name].add((clock() - start) / 1e9)

    def time(self, name: str, fn, *args, block: bool = True, **kwargs):
        with self.span(name):
            out = fn(*args, **kwargs)
            if block:
                _synchronize(out)
        return out

    def report(self) -> str:
        lines = [f"{'step':30s} {'count':>6s} {'mean ms':>9s} {'min':>8s} {'max':>8s}"]
        for name, s in sorted(self.stats.items()):
            lines.append(
                f"{name:30s} {s.count:6d} {s.mean * 1e3:9.2f} "
                f"{s.minimum * 1e3:8.2f} {s.maximum * 1e3:8.2f}"
            )
        return "\n".join(lines)


def _chrome_events(spans: List[Span], base_ns: int) -> List[dict]:
    """The spans as Chrome trace events of this process, one row per thread
    (the one that opened the span), ``ts`` in us from ``base_ns``: a span
    that nests in its row as a complete event, one that overlaps another
    there without nesting (handed between threads) as an async pair."""
    pid = os.getpid()
    names = {**_thread_names, **{t.native_id: t.name for t in threading.enumerate()}}
    events = []
    rows: Dict[int, List[Span]] = defaultdict(list)
    for s in spans:
        rows[s.thread].append(s)
    for tid, row in sorted(rows.items()):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": f"{names.get(tid, 'thread')} ({tid})"}})
        ends: List[int] = []  # the nested spans open at this point of the row
        for s in sorted(row, key=lambda s: (s.start_ns, -s.end_ns)):
            while ends and ends[-1] <= s.start_ns:
                ends.pop()
            ts = (s.start_ns - base_ns) / 1e3
            common = {"name": s.name, "cat": "port", "pid": pid, "tid": tid,
                      "args": {"request": repr(s.request), "id": s.id,
                               "parent": s.parent, **(s.attrs or {})}}
            if not ends or s.end_ns <= ends[-1]:
                ends.append(s.end_ns)
                events.append(dict(common, ph="X", ts=ts,
                                   dur=(s.end_ns - s.start_ns) / 1e3))
            else:
                events.append(dict(common, ph="b", id=s.id, ts=ts))
                events.append(dict(common, ph="e", id=s.id,
                                   ts=(s.end_ns - base_ns) / 1e3))
    return events


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """``torch.profiler`` scope (CPU activities, and CUDA ones where a GPU
    exists) that exports a Chrome trace ``trace.json`` into ``log_dir``,
    with the spans the tracer holds at the end of the block (``take``) on
    the same clock; a no-op when ``log_dir`` is None. Tracing is switched
    apart: ``with tracing(True), device_trace(log_dir): ...``."""
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
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    spans = take()
    if spans:
        with open(path) as f:
            trace = json.load(f)
        trace["traceEvents"] += _chrome_events(
            spans, int(trace.get("baseTimeNanoseconds", 0)))
        with open(path, "w") as f:
            json.dump(trace, f)


def device_busy_ms(events) -> float:
    """The union of the intervals of ``torch.profiler`` device activities,
    in ms: the time the device was busy, overlaps counted once."""
    busy_us, edge = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: e.time_range.start):
        lo, hi = max(e.time_range.start, edge), e.time_range.end
        busy_us += max(0.0, hi - lo)
        edge = max(edge, hi)
    return busy_us / 1000
