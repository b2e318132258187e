"""Entry points that measure the port on the card.

Kernel experiments, each comparing a kernel variant with its baseline and
plain version:

    python -m rovinasemanticsegmentation_tpu_torch.scripts.exp_descent parity|bench
    python -m rovinasemanticsegmentation_tpu_torch.scripts.exp_patches parity|bench

Stage profilers of the main path, splitting its wall time, device time and
launches by stage (``stage_timing`` holds their common code):

    python -m rovinasemanticsegmentation_tpu_torch.scripts.profile_slope [--batch 10]
    python -m rovinasemanticsegmentation_tpu_torch.scripts.profile_normals
    python -m rovinasemanticsegmentation_tpu_torch.scripts.profile_map
    python -m rovinasemanticsegmentation_tpu_torch.scripts.exp_lattice
    python -m rovinasemanticsegmentation_tpu_torch.scripts.exp_filter
"""

from __future__ import annotations

import statistics
import subprocess
from typing import Callable

import torch


def card_description() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def median_ms(
    fn: Callable[[object], object],
    make_input: Callable[[int], object],
    reps: int,
    warmup: int = 3,
) -> float:
    """Median CUDA-event time of ``fn(make_input(i))`` over ``reps`` calls.

    Each call gets a fresh input, made before its timed region, so no result
    can be reused from an earlier call; only ``fn`` lies between the events.
    """
    for i in range(warmup):
        fn(make_input(i))
    events = []
    for i in range(reps):
        x = make_input(warmup + i)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(x)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)
