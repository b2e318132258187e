"""Shared pieces of the harness's tests: a cell's spec cut to a size the CPU
runs in seconds (80x60 frames, maps of 1500 points), and the card fixture.

Run from the repository root, on the CPU: ``python -m pytest port_bench/tests
-q``; on the card, the ``cuda``-marked tests: ``python -m pytest
port_bench/tests -m cuda -q``.
"""

import copy

import pytest
import torch

from port_bench import harness

TINY_CAMERA = {"width": 80, "height": 60, "fx": 65.625, "fy": 65.625,
               "cx": 40.0, "cy": 30.0}
SEED = 2**31 + 12345  # more than 32 signed bits hold


def tiny_spec(workload: str) -> harness.Spec:
    spec = harness.load_spec(workload)
    spec.config = copy.deepcopy(spec.config)
    spec.config["camera"] = dict(TINY_CAMERA)
    traffic = dict(spec.traffic, pool=10, map_points=1500)
    if traffic["driver"] == "stream":
        traffic.update(check_batches=1, trace_batches=1)
    else:
        traffic.update(rate_nodes_per_s=20.0, trace_seconds=0.5, warmup_maps=2,
                       check_maps=2)
    spec.traffic = traffic
    return spec


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")
