"""The command as the benchmark runs it: without a card it exits 3 with no
result; on the card (``cuda``-marked) each cell runs short in both modes,
correct, with the contract's last lines; and a directory that holds only
``BENCHMARK.json`` and the harness gives no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from port_bench import harness
from port_bench.tests.tiny import SEED

CELLS = ("stream_crf10_b10", "online_nocrf")


def command(name, trace, cwd=harness.ROOT, seconds=3):
    return subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", name, "--seed",
         str(SEED), "--seconds", str(seconds), "--trace", str(trace)],
        cwd=cwd, capture_output=True, text=True, timeout=360)


def result_of(out):
    lines = out.stdout.strip().splitlines()
    return json.loads(lines[-1]) if lines else {}


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = command("stream_crf10_b10", 0)
    assert out.returncode == 3
    assert "correct" not in result_of(out)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name, trace):
    out = command(name, trace)
    assert out.returncode == 0, out.stderr[-3000:]
    result = result_of(out)
    assert result["correct"], result
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    checks = out.stderr.strip().splitlines()[-len(result["checks"]):]
    assert all(line.startswith("check ") for line in checks)
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert result["metrics"]


@pytest.mark.cuda
def test_only_the_harness_gives_no_result(card, tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = command("stream_crf10_b10", 0, cwd=tmp_path, seconds=1)
    assert out.returncode != 0
    assert "correct" not in result_of(out)
