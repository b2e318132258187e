"""Device meshes over a ``torch.distributed`` world, and the sharded frame step.

Counterpart of ``rovinasemanticsegmentation_tpu/parallel/mesh.py``. The
reference's concurrency maps onto two mesh axes:

- ``data``: keyframe batches -- the per-frame worker thread
  (``segmenter.cpp:323``) as data parallelism;
- ``model``: forest trees and CRF point shards -- a tree sum or a lattice
  reduction that crosses the axis is a collective over that axis's group.

A mesh here is one process per device slot (``parallel/launch.py`` spawns
them), not XLA's single program: each rank holds its coordinates, its device
and one process group per axis, and runs its share of the work itself.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..models.forest import Forest, TorchForest, build_forest, forest_from_numpy

AXES = ("data", "model")
PROBE_FEATURES = 5 * 5 * 3 + 3  # patch 15 -> 5, depth, height, normal


def mesh_shape(n_devices: int, axis_names: Tuple[str, str] = AXES) -> Dict[str, int]:
    """The factorisation of :func:`make_mesh`: the model axis takes the
    largest of 4 and 2 that divides ``n_devices`` (trees come in small
    counts, resources/config.json:39), the data axis the rest."""
    model = 1
    for cand in (4, 2):
        if n_devices % cand == 0:
            model = cand
            break
    return {axis_names[0]: n_devices // model, axis_names[1]: model}


@dataclass
class DeviceMesh:
    """This rank's place in a 2-D mesh of ranks.

    Rank ``r`` sits at ``(r // model, r % model)``, as
    ``devices.reshape(data, model)`` places devices; ``groups[axis]`` is the
    process group of the ranks that share this rank's other coordinate.
    """

    shape: Dict[str, int]
    coords: Dict[str, int]
    device: torch.device
    groups: Dict[str, dist.ProcessGroup]
    backend: str

    @property
    def rank(self) -> int:
        return dist.get_rank()


def make_mesh(
    n_devices: int,
    axis_names: Tuple[str, str] = AXES,
    device: torch.device | str = "cuda",
) -> DeviceMesh:
    """The mesh of an initialised world of ``n_devices`` ranks; this rank's
    work runs on ``device`` (``"cuda"`` raises where there is no card).

    Every rank creates every axis subgroup, in the same order (a world whose
    ranks call ``new_group`` with different rank lists hangs).
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed "
                           "world (parallel/launch.py)")
    world = dist.get_world_size()
    if world != n_devices:
        raise ValueError(f"mesh of {n_devices} devices in a world of {world}")
    shape = mesh_shape(n_devices, axis_names)
    data, model = shape[axis_names[0]], shape[axis_names[1]]
    rank = dist.get_rank()
    coords = {axis_names[0]: rank // model, axis_names[1]: rank % model}
    grid = np.arange(n_devices).reshape(data, model)
    groups = {}
    for axis, lines in ((axis_names[0], grid.T), (axis_names[1], grid)):
        for line in lines:
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = group
    return DeviceMesh(shape, coords, resolve_device(device), groups,
                      dist.get_backend())


def axis_all_reduce(mesh: DeviceMesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    """Sum ``t`` in place over the ranks of ``axis`` (``jax.lax.psum``)."""
    if mesh.shape[axis] > 1:
        dist.all_reduce(t, group=mesh.groups[axis])
    return t


def axis_all_gather(mesh: DeviceMesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    """``[D, *t.shape]``: every rank's ``t`` along ``axis``, in axis order
    (``jax.lax.all_gather``)."""
    if mesh.shape[axis] == 1:
        return t[None]
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, t, group=mesh.groups[axis])
    return torch.stack(parts)


def shard_range(n: int, mesh: DeviceMesh, axis: str) -> range:
    """This rank's contiguous block of ``n`` items along ``axis``."""
    size = mesh.shape[axis]
    if n % size:
        raise ValueError(f"{n} items do not split over {size} {axis} ranks")
    lo = mesh.coords[axis] * (n // size)
    return range(lo, lo + n // size)


def sub_forest(forest: Forest, trees: Sequence[int],
               device: torch.device) -> TorchForest:
    """Trees ``trees`` of ``forest`` as a forest of their own on ``device``."""
    return forest_from_numpy(
        build_forest([forest.tree_view(t) for t in trees], forest.class_counts,
                     multi_label=forest.multi_label),
        device,
    )


def shard_pipeline(mesh: DeviceMesh, forest: Forest, feature_config,
                   stride: int, fill_value: float):
    """This model rank's frame pipeline: its contiguous block of trees as a
    sub-forest on the rank's device. Build it once and pass it to every
    :func:`shard_batch_frames`."""
    from ..pipelines.single_frame import SingleFramePipeline

    trees = shard_range(forest.num_trees, mesh, "model")
    return SingleFramePipeline(
        feature_config, sub_forest(forest, trees, mesh.device), stride,
        mesh.device, fill_value=fill_value,
    )


def shard_batch_frames(
    mesh: DeviceMesh,
    pipe,  # shard_pipeline(...)
    rgb_stack,  # [B, H, W, 3] uint8
    depth_stack,  # [B, H, W] depth in mm
    kinv_stack,  # [B, 3, 3]
    rot_stack,  # [B, 3, 3]
    trans_stack,  # [B, 3]
) -> Tuple[range, list]:
    """The frame step, data-parallel over keyframes and tree-parallel over
    the forest: -> (this rank's frames, their ``SingleFrameResult``s).

    The data rank takes its contiguous share of the batch; ``pipe`` holds the
    model rank's block of trees (:func:`shard_pipeline`). The rank's frame
    path (kernels A and B on the card) gives the block's ``[B*P, L, C_max]``
    posterior partial, the partials are summed over the model axis, and the
    maps are made from the sum. Kernel B sums a block's trees in order, so
    the result equals the single process's up to float32 summation order.
    """
    frames = shard_range(int(rgb_stack.shape[0]), mesh, "data")
    sl = slice(frames.start, frames.stop)
    post, masks = pipe.stacked_posteriors(
        rgb_stack[sl], depth_stack[sl], kinv_stack[sl], rot_stack[sl],
        trans_stack[sl],
    )
    axis_all_reduce(mesh, post, "model")
    return frames, pipe.results(post, masks, tuple(depth_stack.shape[1:]))


def route_missing_splits_left(forest: Forest) -> None:
    """Make a split on a feature past the probe's 78 (patch 15 -> 5) read
    "feature 0 >= +inf", which goes left on every finite row.

    The JAX dry run draws its forests over 366 features for frames of 78:
    JAX's descent reads NaN past a row (``take_along_axis`` fills) and so
    goes left, where the port refuses such a forest. This is the function JAX
    computes.
    """
    missing = forest.split_feature >= PROBE_FEATURES
    forest.split_feature[missing] = 0
    forest.threshold[missing] = np.inf


def probe_inputs(data: int, model: int):
    """The dry-run probe's inputs, drawn from ``default_rng(0)`` in the JAX
    probe's order: ``2 * data`` frames of 24x32, a random forest of
    ``max(4, model)`` trees (depth 6, 366 features, 8 + 9 classes)."""
    from ..models.forest import random_forest

    rng = np.random.default_rng(0)
    b, h, w = 2 * data, 24, 32
    rgb = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    depth = rng.integers(600, 14000, (b, h, w)).astype(np.uint16)
    kinv = np.tile(
        np.linalg.inv([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]]), (b, 1, 1)
    ).astype(np.float32)
    rot = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    trans = np.zeros((b, 3), dtype=np.float32)
    forest = random_forest(
        rng, num_trees=max(4, model), depth=6, num_features=366,
        class_counts=[8, 9], max_nodes=63,
    )
    route_missing_splits_left(forest)
    return forest, (rgb, depth, kinv, rot, trans)


def shard_batch_pipeline(mesh: DeviceMesh) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """One sharded batched inference step on tiny shapes (dry-run probe).

    -> per layer, the whole batch's posteriors ``[B, H, W, C]`` and labels
    ``[B, H, W]`` (gathered over the data axis), on every rank.
    """
    from ..features.extractor import FeatureConfig

    data, model = mesh.shape["data"], mesh.shape["model"]
    forest, stacks = probe_inputs(data, model)
    b, h, w = stacks[1].shape
    pipe = shard_pipeline(mesh, forest,
                          FeatureConfig(patch_size=15, patch_size_reduce=5), 2,
                          fill_value=0.0)
    _, results = shard_batch_frames(mesh, pipe, *stacks)
    posteriors, labels = [], []
    for li in range(len(forest.class_counts)):
        for out, field in ((posteriors, "posteriors"), (labels, "labels")):
            mine = torch.stack([getattr(r, field)[li] for r in results])
            whole = axis_all_gather(mesh, mine, "data")
            out.append(whole.reshape(b, *whole.shape[2:]).cpu().numpy())
    if labels[0].shape != (b, h, w) or posteriors[1].shape != (b, h, w, 9):
        raise AssertionError(
            f"probe shapes {labels[0].shape}, {posteriors[1].shape}")
    return posteriors, labels
