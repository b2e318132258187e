"""PyTorch port vs JAX reference: the uint8 resize, step timing and tracing,
and simulated annealing.

``resize_bilinear_u8`` is integer arithmetic in int32 (OpenCV's generic 8U
path: 2048-scaled weights rounded independently, the horizontal pass first,
``(acc + 2^21) >> 22``) and must be bit-equal to the JAX function. cv2's
SIMD vertical pass rounds in another order (``((h >> 4) * w) >> 16`` per tap,
then ``(sum + 2) >> 2``), so against ``cv2.resize`` the contract is the JAX
test's: at most 1 LSB (``tests/test_cv2_oracle.py:84-103``).
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rovinasemanticsegmentation_tpu.ops import resize as jresize
from rovinasemanticsegmentation_tpu_torch.ops import resize
from rovinasemanticsegmentation_tpu_torch.utils import mcmc
from rovinasemanticsegmentation_tpu_torch.utils.profiling import (
    StepTimer,
    device_trace,
    span,
    take,
    tracing,
)

cv2 = pytest.importorskip("cv2")

torch.set_num_threads(2)


def _resize_case(src, oh, ow):
    got = resize.resize_bilinear_u8(torch.from_numpy(src), oh, ow).numpy()
    want = np.asarray(jresize.resize_bilinear_u8(jnp.asarray(src), oh, ow))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    cv = cv2.resize(src, (ow, oh), interpolation=cv2.INTER_LINEAR)
    assert np.abs(got.astype(int) - cv.astype(int)).max() <= 1


@pytest.mark.parametrize("w_src", [3, 5, 11, 23, 40, 77, 111, 155])
def test_resize_u8_patch_windows(w_src):
    """tests/test_cv2_oracle.py:91: square windows down (or up) to 11x11."""
    rng = np.random.default_rng(w_src)
    _resize_case(rng.integers(0, 256, (w_src, w_src, 3), dtype=np.uint8), 11, 11)


def test_resize_u8_upsample():
    """tests/test_cv2_oracle.py:101."""
    rng = np.random.default_rng(5)
    _resize_case(rng.integers(0, 256, (7, 9, 3), dtype=np.uint8), 21, 27)


@pytest.mark.parametrize("out", [(11, 11), (21, 27), (240, 320)])
def test_resize_u8_from_vga(out):
    rng = np.random.default_rng(6)
    _resize_case(rng.integers(0, 256, (480, 640, 3), dtype=np.uint8), *out)


def test_resize_u8_single_channel():
    rng = np.random.default_rng(7)
    _resize_case(rng.integers(0, 256, (33, 47), dtype=np.uint8), 13, 9)


class TestProfiling:
    def test_step_timer(self):
        timer = StepTimer()
        with timer.span("a"):
            time.sleep(0.01)
        out = timer.time("b", lambda x: torch.sum(x * 2), torch.ones(16))
        assert float(out) == 32.0
        assert timer.stats["a"].count == 1
        assert timer.stats["a"].mean >= 0.01
        assert timer.stats["b"].count == 1
        report = timer.report()
        assert "a" in report and "mean ms" in report

    def test_step_timer_walks_nested_results(self):
        timer = StepTimer()
        out = timer.time("c", lambda: {"x": [torch.ones(2), (torch.zeros(1), 3)]})
        assert out["x"][1][1] == 3 and timer.stats["c"].count == 1

    def test_device_trace_noop(self):
        with device_trace(None):
            pass

    def test_device_trace_writes_chrome_trace(self, tmp_path):
        """With tracing on, the tracer's spans go into the same file on the
        profiler's clock, each thread on its own row."""
        worker = []

        def work():
            worker.append(threading.get_native_id())
            with span("worker.step", request=4):
                torch.ones(64).cumsum(0)

        log_dir = str(tmp_path / "trace")
        with tracing(True), device_trace(log_dir):
            with span("main.step"):
                torch.ones(64).cumsum(0)
            t = threading.Thread(target=work, name="worker")
            t.start()
            t.join(timeout=10)
        assert not t.is_alive()
        path = os.path.join(log_dir, "trace.json")
        assert os.path.getsize(path) > 0
        events = json.load(open(path))["traceEvents"]
        ours = {e["name"]: e for e in events if e.get("cat") == "port"}
        assert ours["worker.step"]["tid"] == worker[0] != ours["main.step"]["tid"]
        assert ours["worker.step"]["args"]["request"] == "4"
        rows = {e["tid"]: e["args"]["name"] for e in events
                if e.get("ph") == "M" and e.get("name") == "thread_name"}
        assert rows[worker[0]] == f"worker ({worker[0]})"
        step = ours["main.step"]
        ops = [e for e in events if e.get("cat") == "cpu_op" and e["tid"] == step["tid"]]
        assert any(step["ts"] <= o["ts"] and o["ts"] + o["dur"] <= step["ts"] + step["dur"]
                   for o in ops)  # the profiler's cumsum inside the span: one clock
        assert take() == []


class TestMcmc:
    def test_finds_minimum(self):
        """tests/test_aux.py:193 on the port's copy."""
        best, e = mcmc.simulated_annealing(
            initial_state=10.0,
            energy=lambda x: (x - 3.0) ** 2,
            propose=lambda x, rng: x + rng.normal(0, 0.5),
            num_steps=2000,
            cooling=mcmc.GeometricCooling(start=2.0, alpha=0.995),
            seed=1,
        )
        assert abs(best - 3.0) < 0.3
        assert e < 0.1

    def test_cooling_floor(self):
        cool = mcmc.GeometricCooling(start=1.0, alpha=0.5, minimum=0.1)
        assert cool(0) == 1.0 and cool(1) == 0.5 and cool(10) == 0.1
