"""The port's tracer (``utils/profiling.py``): off, it records nothing and
reads no clock; on, spans keep their name, thread, parent and request, on
``torch.profiler``'s clock; the online node's spans of keyframes, maps and
queues, driven inline and by its two threads; the launch counters it holds.

Marked ``cuda``: the test of a span around a kernel launch, which skips
without a card. This file imports nothing of JAX.
"""

import threading
import time

import numpy as np
import pytest
import torch

from rovinasemanticsegmentation_tpu_torch.models.forest import random_forest
from rovinasemanticsegmentation_tpu_torch.ops import (
    forest_cuda,
    forest_staged_cuda,
    patches_cuda,
    patches_separable_cuda,
)
from rovinasemanticsegmentation_tpu_torch.serve import segmenter
from rovinasemanticsegmentation_tpu_torch.utils import profiling
from rovinasemanticsegmentation_tpu_torch.utils.calibration import Calibration
from rovinasemanticsegmentation_tpu_torch.utils.config import Config
from rovinasemanticsegmentation_tpu_torch.utils.profiling import (
    StepTimer,
    span,
    take,
    tracing,
)

torch.set_num_threads(2)

H, W = 24, 32
CAMERA = "camera_front"
TOPICS = [f"/{CAMERA}/rgb/image", f"/{CAMERA}/depth/image"]
CONFIG = {
    "root_dir": "",
    "color_codings": [
        {"name": "material", "coding": [
            {"name": "A", "color": [255, 0, 0], "label": 0},
            {"name": "B", "color": [0, 255, 0], "label": 1},
            {"name": "Unknown", "color": [50, 50, 50], "label": 2},
            {"name": "Void", "color": [0, 0, 0], "label": -1}]},
        {"name": "object", "coding": [
            {"name": "X", "color": [255, 0, 0], "label": 0},
            {"name": "Y", "color": [0, 255, 0], "label": 1},
            {"name": "Z", "color": [0, 0, 255], "label": 2},
            {"name": "Unknown", "color": [50, 50, 50], "label": 3},
            {"name": "Void", "color": [0, 0, 0], "label": -1}]},
    ],
    "use_dense_crf": False, "dcrf_xyz_kernel": 0.5, "dcrf_rgb_kernel": 4.0,
    "dcrf_kernel_weight": 10.0, "dcrf_iterations": 10,
    "rf_prediction_stride": 2, "depth_min": 0.5, "depth_max": 15.0,
    "keyframe_skip_rotation": 0.1, "keyframe_skip_translation": 0.07,
    "patch_size": 15, "patch_size_reduce": 5, "feature_color_patch": True,
    "feature_depth": True, "feature_height": True, "feature_normal": True,
}


@pytest.fixture(autouse=True)
def fresh_tracer():
    """Each test starts and ends with tracing off and no span held."""
    with tracing(False):
        take()
        yield
        take()


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock with tracing off")

    monkeypatch.setattr(profiling, "clock", no_clock)
    a, b = span("a", request=1), span("b", parent=span("c"), parts=3)
    assert a is b  # one shared no-op, nothing allocated
    with a as entered:
        with span("inner"):
            pass
    entered.end()
    assert a.request is None and take() == []


def test_tracing_switches_as_a_call_and_as_a_block():
    assert span("a") is span("b")
    tracing(True)
    try:
        assert span("a") is not span("b")
        with tracing(False):
            assert span("a") is span("b")
        assert span("a") is not span("b")
    finally:
        tracing(False)
    assert span("a") is span("b")
    assert take() == []  # spans never ended record nothing


def test_spans_keep_name_thread_parent_and_request(monkeypatch):
    ticks = iter(range(0, 10_000, 10))  # ns: every clock read 10 later
    monkeypatch.setattr(profiling, "clock", lambda: next(ticks))
    worker_thread = []
    with tracing(True):
        with span("root", request=5) as root:  # 0
            with span("child"):  # 10 - 20
                pass
            handed = span("handed", request=9)  # 30
            with span("child"):  # 40 - 70
                with span("grandchild", request=7):  # 50 - 60
                    pass

            def worker():
                worker_thread.append(threading.get_native_id())
                with handed:  # entered here: the parent of this thread's spans
                    with span("in_worker"):  # 80 - 90
                        pass  # handed ends at 100, root at 110

            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    spans = {(s.name, s.start_ns): s for s in take()}
    main = threading.get_native_id()
    root = spans[("root", 0)]
    first, second = spans[("child", 10)], spans[("child", 40)]
    grand, handed, inner = (spans[("grandchild", 50)], spans[("handed", 30)],
                            next(s for s in spans.values() if s.name == "in_worker"))
    assert root.parent is None and root.request == 5 and root.thread == main
    assert first.parent == second.parent == root.id
    assert first.request == second.request == 5  # the parent's
    assert grand.parent == second.id and grand.request == 7
    assert handed.parent == root.id and handed.thread == main
    assert inner.parent == handed.id and inner.request == 9
    assert inner.thread == worker_thread[0] != main
    assert (first.end_ns, second.end_ns, handed.end_ns, root.end_ns) == (20, 70, 100, 110)
    own = profiling.self_ns(list(spans.values()))
    # root's children cover 10-20 and 30-100 (the second child, 40-70, lies
    # inside the handed span)
    assert own[root.id] == 110 - (10 + 70)
    assert own[second.id] == 30 - 10 and own[grand.id] == own[first.id] == 10
    assert own[handed.id] == 70 - 10


def test_parts_end_at_the_last():
    with tracing(True):
        s = span("keyframe", request=3, parts=2)
        s.end()
        assert take() == []
        s.end()
    (got,) = take()
    assert got.name == "keyframe" and got.request == 3


def test_clock_agrees_with_the_profiler():
    """A span and a ``record_function`` range around the same block, under a
    CPU ``torch.profiler``: within 100 us at both ends (the median of 9
    blocks, so that a thread switched out between the two entries, which
    delays one block, does not count as a clock's offset)."""
    import statistics

    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.ones(4096)
    with tracing(True), profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):  # a profile's first range pays once
            x.cumsum(0)
        for i in range(9):
            with span(f"block{i}"), record_function(f"block{i}"):
                for _ in range(20):
                    x.cumsum(0)
                time.sleep(0.002)
    ours = {s.name: s for s in take()}
    theirs = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("block")}
    assert len(ours) == 9 and set(theirs) >= set(ours)
    starts = [theirs[n].start_ns() - s.start_ns for n, s in ours.items()]
    ends = [s.end_ns - (theirs[n].start_ns() + theirs[n].duration_ns())
            for n, s in ours.items()]
    assert abs(statistics.median(starts)) < 100_000, starts
    assert abs(statistics.median(ends)) < 100_000, ends


def test_step_timer_is_a_view_of_the_tracer():
    timer = StepTimer()
    with timer.span("off"):
        pass
    with tracing(True):
        out = timer.time("on", lambda: torch.ones(4) * 2)
    assert float(out.sum()) == 8.0
    assert timer.stats["off"].count == timer.stats["on"].count == 1
    (got,) = take()
    assert got.name == "on"
    assert timer.stats["on"].total == pytest.approx((got.end_ns - got.start_ns) / 1e9,
                                                    abs=1e-4)


@pytest.mark.parametrize("module,attr,name", [
    (forest_cuda, "launches", "forest_cuda.launches"),
    (forest_staged_cuda, "launches", "forest_staged_cuda.launches"),
    (patches_cuda, "launches", "patches_cuda.launches"),
    (patches_cuda, "pack_launches", "patches_cuda.pack_launches"),
    (patches_separable_cuda, "launches", "patches_separable_cuda.launches"),
])
def test_launch_counters_are_the_tracers(module, attr, name):
    c = getattr(module, attr)
    assert c is profiling.counter(name)
    before = c.value
    c.add()
    assert c.value == before + 1
    c.reset()
    assert c.value == 0 and profiling.counter(name).value == 0


def _forest():
    rng = np.random.default_rng(0)
    forest = random_forest(rng, num_trees=2, depth=6, num_features=78,
                           class_counts=[3, 4], max_nodes=61)
    hi = np.where(forest.split_feature < 75, 255.0, 3.0)
    forest.threshold[:] = rng.uniform(0.0, hi).astype(np.float32)
    return forest


def _pose(x):
    p = np.eye(4, dtype=np.float32)
    p[0, 3] = x
    return p


@pytest.mark.parametrize("mode", ["drain", "threads"])
def test_segmenter_spans(mode):
    """Every node gets a ``runtime.keyframe`` span under its id with a
    ``runtime.frame_queue`` child, the frame worker's batches and the frame
    path's stages serve those ids, and every map gets a ``runtime.map`` span
    under its id, with its queue wait and fusion under it."""
    seg = segmenter.Segmenter(Config(data=CONFIG), TOPICS, "cpu", forest=_forest())
    calib = Calibration(intrinsic=np.array([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]]),
                        rotation=np.eye(3), translation=np.zeros(3))
    rng = np.random.default_rng(1)
    nodes, maps = [1, 2, 3, 4], [7, 8]
    with tracing(True):
        seg.initialize_projector([CAMERA], [calib], (H, W))
        if mode == "drain":
            seg.stop()
        try:
            for n in nodes:
                seg.push_color(CAMERA, n, rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
                seg.push_depth(CAMERA, n, rng.integers(600, 9000, (H, W)).astype(np.uint16))
                assert seg.on_new_node(segmenter.MapNode(n, _pose(0.1 * n), [n]))
            for m, part in zip(maps, (nodes[:2], nodes[2:])):
                pts = rng.uniform(-0.5, 2.0, (50, 3)).astype(np.float32) + [0, 0, 1.5]
                seg.on_new_local_map(segmenter.LocalMapData(
                    m, [segmenter.MapNode(n, _pose(0.1 * n), [n]) for n in part],
                    pts.astype(np.float32)))
            if mode == "drain":
                seg.drain()
            else:
                deadline = time.monotonic() + 60
                while len(seg.stored_semantics_ids()) < len(maps):
                    assert time.monotonic() < deadline, "maps not served"
                    time.sleep(0.01)
        finally:
            seg.stop()
    assert all(not t.is_alive() for t in seg._threads)
    spans = take()
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    keyframes = {s.request: s for s in by_name["runtime.keyframe"]}
    assert sorted(keyframes) == nodes
    queued = {s.request: s for s in by_name["runtime.frame_queue"]}
    assert sorted(queued) == nodes
    for n in nodes:
        k, q = keyframes[n], queued[n]
        assert q.parent == k.id and k.start_ns <= q.start_ns <= q.end_ns <= k.end_ns
    batches = by_name["runtime.frame_batch"]
    assert sorted(n for b in batches for n in b.request) == nodes
    ids = {b.id for b in batches}
    for stage in ("frame.lab_pad", "frame.patches", "frame.normals", "frame.descent",
                  "frame.results"):
        assert by_name[stage] and all(s.parent in ids for s in by_name[stage]), stage
    roots = {s.request: s for s in by_name["runtime.map"]}
    assert sorted(roots) == maps
    for name in ("runtime.map_queue", "map.fusion", "map.to_host"):
        assert sorted(s.request for s in by_name[name]) == maps, name
        assert all(s.parent == roots[s.request].id for s in by_name[name]), name
    if mode == "threads":
        main = threading.get_native_id()
        assert all(s.thread != main for s in batches + by_name["map.fusion"])


@pytest.mark.parametrize("on", [False, True])
@pytest.mark.parametrize("name", ["stream_crf10_b10", "online_nocrf"])
def test_benchmark_cells_trace_only_when_switched_on(name, on):
    """A ``--trace 0`` run of each benchmark cell on the CPU driver path, at a
    tiny size: the port records no span, and tracing is off after it; with
    tracing switched on around the same run, the cell's path records its
    spans."""
    from port_bench import harness
    from port_bench.tests.tiny import SEED, tiny_spec

    torch.manual_seed(0)
    with tracing(on):
        result, checks = harness.measure(tiny_spec(name), SEED, 1.0, False, "cpu",
                                         time.perf_counter())
    assert result["correct"], checks
    assert span("a") is span("b")  # off: the shared no-op
    names = {s.name for s in take()}
    if not on:
        assert names == set()
    else:
        assert {"frame.normals", "frame.descent", "map.fusion"} <= names
        if name == "online_nocrf":
            assert {"runtime.keyframe", "runtime.frame_queue", "runtime.map",
                    "runtime.map_queue", "map.to_host"} <= names
        else:
            assert {"map.lattice_build", "map.mean_field"} <= names


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_span_holds_its_kernel_launch(card):
    """On the card: a span around one kernel launch holds the launch's
    ``cudaLaunchKernel`` host event and starts before the kernel does."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 20, device=card)
    (x * 2).sum()
    torch.cuda.synchronize(card)
    with tracing(True), profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        with span("launch"):
            y = torch.neg(x)
        torch.cuda.synchronize(card)
    (s,) = take()
    events = list(prof.profiler.kineto_results.events())
    launches = [e for e in events if e.name() == "cudaLaunchKernel"]
    kernels = [e for e in events if e.device_type() == DeviceType.CUDA
               and not e.is_user_annotation()]
    assert len(launches) == 1 and len(kernels) == 1, [e.name() for e in events]
    launch, kernel = launches[0], kernels[0]
    assert s.start_ns <= launch.start_ns()
    assert launch.start_ns() + launch.duration_ns() <= s.end_ns
    assert s.start_ns <= kernel.start_ns()
    assert float(y[0]) == -1.0
