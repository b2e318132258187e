"""The published training recipe on the card: two VGA images, 6 variants
each, through ``extract_training_rows`` and ``learn`` (the benchmark's cell
``train_recipe_12img`` cut to two images), held to the plain reference:
tree 0 node for node (``tree_node_mismatch`` 0.0), and every row of both
images within the cell's tolerance.

Marked ``cuda``: each test skips when ``torch.cuda.is_available()`` is
false. On a machine with an NVIDIA GPU:

    python -m pytest --noconftest -m cuda tests/test_torch_train_recipe_cuda.py -q

This file imports nothing of JAX.
"""

import copy

import pytest
import torch

from port_bench import harness
from port_bench.drivers import train as driver

pytestmark = pytest.mark.cuda

SEED = 4 * 536870917  # tree seed mod 4 = 0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def test_two_images_equal_the_reference(dev):
    spec = harness.load_spec("train_recipe_12img")
    spec.config = copy.deepcopy(spec.config)
    spec.config["training_images"] = 2
    spec.traffic = dict(spec.traffic, check_images=2)
    cell = driver.Cell(spec, SEED, "cuda")
    cell.release()
    x, _, forest = cell.last
    assert x.is_cuda and len(x) > 100000 and min(forest.node_counts) > 1000
    checks = cell.check()
    assert checks["tree_node_mismatch"] == 0.0, checks
    assert checks["train_row_mismatch"] <= spec.limits["train_row_mismatch"], checks
