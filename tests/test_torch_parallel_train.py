"""PyTorch port: tree-parallel training, and the world launcher's failures.

``learn_forest_parallel`` grows each tree on a host thread over a list of
device slots (here ``[cpu, cpu]``, and 16 threads on one CPU); its forest
must equal the port's sequential trainer's, and JAX's
``learn_forest_parallel`` on the same numpy data (the dry run's part 3
set) up to near-ties (``train/compare.py``), in host growth and in device
growth with the exact and the binned search. ``parallel/launch.py`` must
raise, and leave no process behind, when a rank raises or when a world
outlives its deadline.
"""

import multiprocessing
import sys
import time
import warnings

import jax
import pytest
import torch

from rovinasemanticsegmentation_tpu.parallel.tree_parallel import (
    learn_forest_parallel as j_learn_forest_parallel,
)
from rovinasemanticsegmentation_tpu.train import forest_trainer as J
from rovinasemanticsegmentation_tpu_torch.parallel import dryrun
from rovinasemanticsegmentation_tpu_torch.parallel.launch import (
    Call,
    choose_backend,
    run_world,
)
from rovinasemanticsegmentation_tpu_torch.parallel.tree_parallel import (
    learn_forest_parallel,
)
from rovinasemanticsegmentation_tpu_torch.train import forest_trainer as T

from forest_parity import assert_leaf_hist_close, assert_same_or_near_tie
from test_torch_train_forest import MODES, _assert_forests_equal

BASE = dict(num_trees=2, max_depth=5, min_split_examples=10, seed=7)


@pytest.fixture(scope="module")
def data():
    inp = dryrun.crf_inputs()
    return inp["xs"], inp["ys"]


def _sequential(cfg, xs, ys):
    return T.ForestTrainer(cfg, "cpu").learn(xs, ys, class_counts=[3],
                                             progress=False)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_parallel_equals_sequential(data, mode):
    xs, ys = data
    cfg = T.TrainerConfig(**BASE, **MODES[mode])
    par = learn_forest_parallel(cfg, xs, ys, class_counts=[3],
                                devices=["cpu", "cpu"])
    _assert_forests_equal(par, _sequential(cfg, xs, ys))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_parallel_equals_jax_parallel(data, mode):
    xs, ys = data
    kw = dict(BASE, **MODES[mode])
    cfg = T.TrainerConfig(**kw)
    want = j_learn_forest_parallel(J.TrainerConfig(**kw), xs, ys,
                                   class_counts=[3], devices=jax.devices()[:2])
    got = learn_forest_parallel(cfg, xs, ys, class_counts=[3],
                                devices=["cpu", "cpu"])
    for tie in assert_same_or_near_tie(want, got, xs, ys, cfg):
        warnings.warn(f"near-tie: {tie}")
    assert_leaf_hist_close(want, got)


def test_many_threads_equal_sequential(data):
    """16 trees on 16 threads sharing one staged set (more threads than
    cores, a short switch interval): the trees must not mix."""
    xs, ys = data
    cfg = T.TrainerConfig(**dict(BASE, num_trees=16, max_depth=4))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        par = learn_forest_parallel(cfg, xs, ys, class_counts=[3],
                                    devices=["cpu"] * 16)
    finally:
        sys.setswitchinterval(old)
    _assert_forests_equal(par, _sequential(cfg, xs, ys))


def test_backend_choice():
    assert choose_backend("cpu", 8) == "gloo"
    with pytest.raises(ValueError):
        choose_backend("tpu", 1)
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        assert choose_backend("cuda", n) == "nccl"
        assert choose_backend("cuda", n + 1) == "gloo"
    else:
        with pytest.raises(RuntimeError):
            choose_backend("cuda", 1)


def test_rank_failure_raises():
    with pytest.raises(RuntimeError, match="needs a CUDA rank"):
        run_world(2, [Call("parallel.dryrun:probe_cuda_all_gather")],
                  device="cpu", timeout=120)
    assert multiprocessing.active_children() == []


def test_world_past_its_deadline_raises():
    start = time.monotonic()
    with pytest.raises(TimeoutError):
        run_world(2, [Call("parallel.mesh:shard_batch_pipeline")],
                  device="cpu", timeout=0.5)
    assert time.monotonic() - start < 30
    assert multiprocessing.active_children() == []


def test_default_device_is_the_card(data, monkeypatch):
    """Without ``device``/``devices`` the sharded paths ask for the card and
    raise where there is none, before any rank starts."""
    xs, ys = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="is_available"):
        run_world(2, [Call("parallel.mesh:shard_batch_pipeline")], timeout=30)
    with pytest.raises(RuntimeError, match="is_available"):
        learn_forest_parallel(T.TrainerConfig(**BASE), xs, ys, class_counts=[3])
    assert multiprocessing.active_children() == []
