"""Each per-layer metric's reader on a recorded synthetic trace, and on a
trace in which it finds nothing to read; spans inside the port, which the
profiler records as device-side annotations, move no reading."""

import contextlib

import pytest

from port_bench import harness
from port_bench.drivers.stream import FRAME_SPAN, MAP_SPAN
from port_bench.trace import DeviceClock, Trace, TracedRun, busy_us, union

# Device activities in us: two overlapping kernels, a copy, kernel A twice,
# kernel B once; the window is 1000 us of the host's clock.
DEVICE = [("normals_kernel", 0.0, 100.0), ("roll_kernel", 50.0, 150.0),
          ("Memcpy DtoH", 400.0, 420.0), ("patches_kernel<3>", 500.0, 540.0),
          ("patches_kernel<3>", 600.0, 660.0), ("forest_descent_kernel", 700.0, 900.0)]
HOST = [("aten::copy_", 150.0, 400.0), ("cudaLaunchKernel", 420.0, 430.0),
        ("aten::index", 420.0, 500.0)]
SPANS = [(FRAME_SPAN, 0.0, 450.0), (MAP_SPAN, 450.0, 1000.0)]


def data(**kw):
    real = Trace(DEVICE, [], HOST, wall_s=1e-3)
    fields = dict(real=real, keyframes=4, maps=2, wall_s=1e-3,
                  run={"attempted": 2, "failed": 0, "info": {}},
                  replay=Trace(DEVICE, SPANS, HOST, wall_s=1e-3),
                  counters={"forest_descent_launches": 2},
                  least_s={"patches": 25e-6, "descent": 100e-6, "step": 1e-6},
                  window={"metrics": {"keyframes_per_s": 51.5, "map_latency_p95_ms": 47.25}})
    fields.update(kw)
    return TracedRun(**fields)


EXPECTED = {
    "device_idle_share.stream": 100 * (1 - 470e-6 / 1e-3),
    "device_idle_share.online": 100 * (1 - 470e-6 / 1e-3),
    "device_activities_per_kf.stream": 6 / 4,
    "device_activities_per_kf.online": 6 / 4,
    "frame_path_device_ms_per_kf.stream": 1000 * 220e-6 / 4,
    "map_path_device_ms_per_map.stream": 1000 * 300e-6 / 2,
    "patches_roofline": 100 * 25e-6 / 50e-6,
    "forest_descent_roofline": 100 * 100e-6 / 200e-6,
    "mfu.stream": 100 * 1e-6 / (1e-3 / 4),
    "keyframes_per_descent.online": 4 / 2,
    "keyframes_per_s.stream": 51.5,
    "map_latency_p95_ms.online": 47.25,
}


def test_every_metric_has_a_case():
    names = {m["name"] for m in harness.load_spec("stream_crf10_b10").bench["per_layer"]}
    assert names == set(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_recorded_trace(name):
    assert busy_us(DEVICE) == 470.0
    value = harness.reader(name).read(data())
    assert value == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_finds_nothing(name):
    empty = data(real=Trace([], [], HOST, wall_s=1e-3), replay=None,
                 counters={}, least_s={}, window={})
    assert harness.reader(name).read(empty) is None


def test_union_counts_overlaps_once():
    assert busy_us(DEVICE) == busy_us(DEVICE[::-1]) == 470.0
    assert union([0, 2, 20], [10, 5, 20]) == 10.0
    assert union([], []) == busy_us([]) == 0.0
    big = 1_790_000_000_000_000_000  # ns since the epoch: exact in whole numbers
    assert union([big, big + 1], [big + 3, big + 5]) == 5.0


def test_breakdown_charges_gaps_to_the_host():
    b = Trace(DEVICE, [], HOST, wall_s=1e-3).breakdown()
    assert b["device_ops"][0] == ["forest_descent_kernel", pytest.approx(200e-6)]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx(250e-6)  # 150-400
    assert gaps["aten::index"] == pytest.approx(80e-6)  # 420-500
    assert gaps["no host operation recorded"] == pytest.approx(100e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


class _Event:
    """What ``Trace.from_profile`` reads of an event in the profiler's
    results (times in us here, in ns there)."""

    def __init__(self, name, start, end, device="CUDA", annotation=False):
        from torch.autograd import DeviceType

        self.name = lambda: name
        self.start_ns, self.duration_ns = lambda: int(start * 1e3), lambda: int((end - start) * 1e3)
        self.device_type = lambda: getattr(DeviceType, device)
        self.is_user_annotation = lambda: annotation


class _Profile:
    def __init__(self, events):
        from types import SimpleNamespace

        self.profiler = SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_device_clock_reads_a_window(monkeypatch):
    """The clock's busy time is the union of the card's recorded
    activities, user annotations and the host's operations left out."""
    import torch

    events = _replay_events(port_span=False) + [_Event("port::normals", 0.0, 160.0, annotation=True)]
    monkeypatch.setattr("torch.profiler.profile", lambda activities: _Profile(events))
    with DeviceClock(torch.device("cuda")) as clock:
        pass
    assert clock.busy_s == pytest.approx(470e-6) and clock.activities == len(DEVICE)


def _replay_events(port_span):
    """The replay's events: the harness's spans on the host and the device,
    the device activities, and optionally a span inside the port around
    the first two kernels, recorded as the profiler records a
    ``record_function`` (a host range and a device-side annotation; the
    latter flagged or not, as profiler versions differ)."""
    events = [_Event(n, s, e, device="CPU", annotation=True) for n, s, e in SPANS]
    events += [_Event(n, s, e, annotation=True) for n, s, e in SPANS]
    events += [_Event(n, s, e) for n, s, e in DEVICE]
    events += [_Event(n, s, e, device="CPU") for n, s, e in HOST]
    if port_span:
        events += [_Event("port::normals", 0.0, 160.0, device="CPU", annotation=True),
                   _Event("port::normals", 0.0, 160.0, annotation=True),
                   _Event("port::normals", 0.0, 160.0)]
    return events


def test_spans_inside_the_port_move_nothing():
    plain, spanned = (Trace.from_profile(_Profile(_replay_events(p)), 1e-3,
                                         span_names=(FRAME_SPAN, MAP_SPAN))
                      for p in (False, True))
    assert plain.device == DEVICE and spanned.device == DEVICE
    assert spanned.busy_s == plain.busy_s == pytest.approx(470e-6)
    assert spanned.span_totals() == plain.span_totals()
    assert plain.span_totals()[FRAME_SPAN] == (pytest.approx(220e-6), 3)
    for name in EXPECTED:
        traced = data(real=spanned, replay=spanned)
        assert (harness.reader(name).read(traced)
                == harness.reader(name).read(data(real=plain, replay=plain)))


@pytest.mark.cuda
def test_a_real_span_inside_the_port_moves_nothing(card):
    """On the card: the same work traced with and without a
    ``record_function`` around it leaves the same device activities; the
    harness's own span keeps its range."""
    import torch
    from torch.profiler import profile, record_function

    from port_bench.trace import activities

    x = torch.ones(1 << 20, device=card)

    def work():
        with record_function(FRAME_SPAN):
            (x * 2 + 1).sum()
            torch.cumsum(x, 0)
        torch.cuda.synchronize(card)

    traces = []
    for port_span in (False, True):
        work()
        with profile(activities=activities(card)) as prof:
            with record_function("port::inner") if port_span else contextlib.nullcontext():
                work()
        traces.append(Trace.from_profile(prof, 1.0, span_names=(FRAME_SPAN,)))
    plain, spanned = traces
    assert plain.device and sorted(n for n, _, _ in spanned.device) == sorted(
        n for n, _, _ in plain.device)
    assert not any("port::inner" in n or n == FRAME_SPAN for n, _, _ in spanned.device)
    assert [n for n, _, _ in spanned.spans] == [FRAME_SPAN]
    assert spanned.span_totals()[FRAME_SPAN][1] == len(spanned.device)
