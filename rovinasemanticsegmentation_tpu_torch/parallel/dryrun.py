"""The multi-rank dry run: every sharded path of the port in one world,
held against the port's single-process functions.

Counterpart of ``__graft_entry__.py``'s ``dryrun_multichip`` and
``_dryrun_streaming_fused``, on the same seeded inputs and with the same
tolerances::

    python -m rovinasemanticsegmentation_tpu_torch.parallel.dryrun --ranks 8 --device cpu|cuda

One world of ``--ranks`` processes (``parallel/launch.py``: ``gloo`` on the
CPU and on a card the ranks share, ``nccl`` with a card per rank) runs

1. the frame step, data-parallel over keyframes and tree-parallel over the
   forest (``parallel/mesh.py::shard_batch_pipeline``): posteriors within
   rtol 1e-6 of the single process's (the tree sum's float32 order differs),
   labels equal except where the top two classes are within 2 ulp;
2. the point-sharded mean field (points-major), 2b. its ``[C, N]`` variant
   and the vertex-sharded one, and 2c. the automatic choice between the last
   two (``replicated`` on a random cloud, ``vertex`` on a smooth
   trajectory): each within rtol 2e-4 / atol 2e-5 of the single-device mean
   field;
5. the streaming step with each data rank's contiguous, ``map_every``-aligned
   share of the keyframes and its maps: frame and map labels equal to the
   single-process worker path bit for bit.

Part 3, tree-parallel training, runs in this process on threads over two
device slots (``parallel/tree_parallel.py``) and must equal the sequential
trainer; part 4, the fused forest (``ForestTrainer.learn``: every tree in
one level loop, refit in one descent), runs in this process too and must
equal the tree loop (``ForestTrainer.grow_tree`` per tree) bit for bit.

The functions below that take a mesh run in every rank; each returns numpy
arrays, which go back to the parent.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from .launch import Call, run_world
from .mesh import (
    DeviceMesh,
    mesh_shape,
    probe_inputs,
    route_missing_splits_left,
    shard_range,
)

MAP_EVERY = 2  # keyframes per map in part 5


# ----------------------------------------------------------------------
# Inputs, in the JAX dry run's draw order
# ----------------------------------------------------------------------


def trajectory_features(n: int = 512) -> np.ndarray:
    """Part 2c's smooth trajectory: contiguous shard arcs."""
    t = np.linspace(0, 200, n)
    return np.stack(
        [t * 0.25, np.sin(t * 0.2), np.cos(t * 0.13),
         np.sin(t * 0.07), np.cos(t * 0.05), t * 0.01], axis=1
    ).astype(np.float32)


def crf_inputs() -> Dict[str, np.ndarray]:
    """Parts 2-3's draws from ``default_rng(0)``: 203 random points with 5
    classes, the 512-point trajectory's unaries, and part 3's training set."""
    rng = np.random.default_rng(0)
    n, c = 203, 5
    out = {"unary": rng.normal(size=(n, c)).astype(np.float32),
           "feats": rng.normal(size=(n, 6)).astype(np.float32)}
    out["feats2"] = trajectory_features()
    out["unary2"] = rng.normal(size=(512, c)).astype(np.float32)
    xs = rng.normal(size=(300, 12)).astype(np.float32)
    out["xs"] = xs
    out["ys"] = (xs[:, 0] + xs[:, 3] > 0).astype(np.int8) + (xs[:, 1] > 0.5)
    return out


def streaming_inputs(data: int) -> dict:
    """Part 5's draws from ``default_rng(2)``: ``2 * data`` keyframes of
    32x40, a 2-tree forest, one 70-point cloud per ``MAP_EVERY`` keyframes."""
    from ..models.forest import random_forest

    rng = np.random.default_rng(2)
    h, w, n = 32, 40, 70
    batch = 2 * data
    forest = random_forest(rng, num_trees=2, depth=6, num_features=366,
                           class_counts=[3, 4], max_nodes=101)
    route_missing_splits_left(forest)
    rgbs = np.stack([rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                     for _ in range(batch)])
    depths = np.stack([rng.integers(600, 9000, (h, w)).astype(np.uint16)
                       for _ in range(batch)])
    intrinsic = np.array([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]])
    kinv = np.tile(np.linalg.inv(intrinsic)[None], (batch, 1, 1)).astype(
        np.float32)
    pts = np.stack(
        [rng.uniform(-0.3, 0.3, n), rng.uniform(-0.25, 0.25, n),
         rng.uniform(1.5, 2.5, n)], axis=1,
    ).astype(np.float32)
    n_maps = batch // MAP_EVERY
    return dict(
        forest=forest, intrinsic=intrinsic, rgbs=rgbs, depths=depths,
        kinv=kinv, rot=np.tile(np.eye(3, dtype=np.float32)[None], (batch, 1, 1)),
        trans=np.zeros((batch, 3), np.float32),
        clouds=np.stack([pts + 0.01 * m for m in range(n_maps)]),
        crgb=rng.uniform(0, 1, (n, 3)).astype(np.float32),
    )


# ----------------------------------------------------------------------
# Functions run in every rank
# ----------------------------------------------------------------------


def timed_frame_step(mesh: DeviceMesh, forest, feature_config, stride: int,
                     stacks, fill_value: float, reps: int = 3) -> dict:
    """The frame step (``mesh.shard_batch_frames``) ``reps`` times on this
    rank's sub-forest pipeline, built once before the first run, each run
    after a barrier: -> this rank's frames, their posteriors and labels (of
    the last run), the wall ms of each run (host clock, synchronised; the
    sub-forest's build and upload are outside it), and the launches of
    kernels A (and its Lab pack) and B over the runs.

    Then the step's two halves, ``reps`` times each, alone: the rank's
    posterior partial (``partial_ms``) and its ``all_reduce`` over the model
    axis (``all_reduce_ms``). Their launches are not counted.
    """
    import torch.distributed as dist

    from .launch import launch_counts, reset_launch_counts
    from .mesh import axis_all_reduce, shard_batch_frames, shard_pipeline

    def timed(fn):
        dist.barrier()
        t0 = time.perf_counter()
        out = fn()
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        return out, 1000 * (time.perf_counter() - t0)

    pipe = shard_pipeline(mesh, forest, feature_config, stride, fill_value)
    reset_launch_counts(mesh)
    ms = []
    for _ in range(reps):
        (frames, results), t = timed(
            lambda: shard_batch_frames(mesh, pipe, *stacks))
        ms.append(t)
    launches = launch_counts(mesh)
    sl = slice(frames.start, frames.stop)
    partial_ms, all_reduce_ms = [], []
    for _ in range(reps):
        (post, _), t = timed(
            lambda: pipe.stacked_posteriors(*(a[sl] for a in stacks)))
        partial_ms.append(t)
        all_reduce_ms.append(timed(lambda: axis_all_reduce(mesh, post, "model"))[1])
    return {
        "frames": list(frames),
        "posteriors": [[p.cpu().numpy() for p in r.posteriors] for r in results],
        "labels": [[l.cpu().numpy() for l in r.labels] for r in results],
        "ms": ms,
        "partial_ms": partial_ms,
        "all_reduce_ms": all_reduce_ms,
        "partial_bytes": post.numel() * post.element_size(),
        "launches": launches,
    }


def mean_field_variants(
    mesh: DeviceMesh, axis: str, unary, lattice, norm, weight: float,
    blocks: Sequence[int], n_iterations: int,
    variants: Sequence[str] = ("points", "transposed", "vertex", "auto"),
) -> dict:
    """Parts 2-2c on one cloud: each named sharded mean field's ``[N, C]``
    marginals, the automatic choice and both comm volumes per filter."""
    from .sharded_crf import sharded_potts_mean_field, sharded_potts_mean_field_t
    from .sharded_lattice import (
        auto_sharded_potts_mean_field,
        plan_sharded_lattice,
        vertex_sharded_potts_mean_field,
    )

    plan = plan_sharded_lattice(lattice, mesh.shape[axis])
    out = {"halo_comms": plan.comms_per_filter,
           "replicated_comms": plan.replicated_comms_per_filter}
    for v in variants:
        if v == "points":
            q = sharded_potts_mean_field(mesh, axis, unary, lattice, norm,
                                         weight, n_iterations)
        elif v == "transposed":
            q = sharded_potts_mean_field_t(mesh, axis, unary, lattice, weight,
                                           blocks, n_iterations)
        elif v == "vertex":
            q = vertex_sharded_potts_mean_field(
                mesh, axis, unary, lattice, weight, blocks, n_iterations,
                plan=plan)
        else:
            q, out["variant"] = auto_sharded_potts_mean_field(
                mesh, axis, unary, lattice, weight, blocks, n_iterations,
                plan=plan)
        out[v] = q.cpu().numpy()
    return out


def map_labels(mesh: DeviceMesh, projector, points, rgb, class_counts,
               unknown_labels, crf, unaries=None, nodes=None) -> dict:
    """``LocalMapPipeline(mesh=...)``'s labels of one map, and the variant it
    chose: from the map's fused ``unaries`` (:meth:`label_map_sharded`), or
    from its keyframe ``nodes`` (:meth:`run_device`)."""
    from ..pipelines.local_map import LocalMapPipeline

    pipe = LocalMapPipeline(projector, class_counts, unknown_labels,
                            mesh.device, crf=crf, mesh=mesh)
    labels = (pipe.run_device(points, rgb, nodes) if unaries is None
              else pipe.label_map_sharded(points, rgb, unaries))
    return {"labels": [l.cpu().numpy() for l in labels],
            "variant": pipe.last_crf_variant}


def _streaming_pipelines(case: dict, device):
    from ..features.extractor import FeatureConfig
    from ..fusion.projector import MultiProjector
    from ..pipelines.local_map import CrfParams, LocalMapPipeline
    from ..pipelines.single_frame import SingleFramePipeline
    from ..utils.calibration import Calibration

    h, w = case["depths"].shape[1:]
    proj = MultiProjector.from_calibrations(
        [Calibration(case["intrinsic"], np.eye(3), np.zeros(3))], h, w,
        min_distance=0.5, max_distance=15.0)
    fp = SingleFramePipeline(
        FeatureConfig(patch_size=15, patch_size_reduce=5), case["forest"], 2,
        device, fill_value=0.0)
    mp = LocalMapPipeline(proj, [3, 4], [2, 3], device,
                          crf=CrfParams(use_dense_crf=True, iterations=3))
    return proj, fp, mp


def streaming_share(mesh: DeviceMesh, case: dict) -> dict:
    """Part 5: ``StreamingPipeline.run_staged`` on this data rank's share of
    the keyframes and its maps (after one validating map, as the worker
    path's first map validates the vertex bucket)."""
    from ..pipelines.local_map import MapNodeFrames
    from ..pipelines.streaming import StreamingPipeline, pack_poses

    proj, fp, mp = _streaming_pipelines(case, mesh.device)
    frames = shard_range(len(case["rgbs"]), mesh, "data")
    maps = shard_range(len(case["clouds"]), mesh, "data")
    if frames.start != maps.start * MAP_EVERY:
        raise ValueError("a data rank's keyframes must start its first map")
    fs, ms = slice(frames.start, frames.stop), slice(maps.start, maps.stop)
    mp.run_device(case["clouds"][maps.start], case["crgb"],
                  [MapNodeFrames(pose=np.eye(4), posteriors=[None])])
    poses = pack_poses(proj, [np.eye(4)] * MAP_EVERY)
    frame_labels, map_labels_ = StreamingPipeline(fp, mp, MAP_EVERY).run_staged(
        case["rgbs"][fs], case["depths"][fs], case["kinv"][fs],
        case["rot"][fs], case["trans"][fs], case["clouds"][ms], case["crgb"],
        np.stack([poses] * len(maps)),
    )
    mp.flush()
    return {
        "frames": list(frames), "maps": list(maps),
        "frame_labels": [[l.cpu().numpy() for l in f] for f in frame_labels],
        "map_labels": [[l.cpu().numpy() for l in m] for m in map_labels_],
    }


def streaming_reference(case: dict, device) -> dict:
    """Part 5's single-process worker path: the batch, then each map."""
    from ..pipelines.local_map import MapNodeFrames

    _, fp, mp = _streaming_pipelines(case, device)
    results = fp.run_batch_stacked(case["rgbs"], case["depths"], case["kinv"],
                                   case["rot"], case["trans"])
    maps = []
    for m, cloud in enumerate(case["clouds"]):
        nodes = [MapNodeFrames(pose=np.eye(4), posteriors=[list(r.posteriors)])
                 for r in results[m * MAP_EVERY : (m + 1) * MAP_EVERY]]
        maps.append([l.cpu().numpy()
                     for l in mp.run_device(cloud, case["crgb"], nodes)])
    mp.flush()
    return {"frame_labels": [[l.cpu().numpy() for l in r.labels]
                             for r in results],
            "map_labels": maps}


def gathered_streaming(shares: Sequence[dict], n_frames: int,
                       n_maps: int) -> dict:
    """Every frame's and map's labels from the data ranks' shares; ranks
    that hold the same share must agree bit for bit."""
    frames: List = [None] * n_frames
    maps: List = [None] * n_maps
    for share in shares:
        for dst, idx, got in ((frames, share["frames"], share["frame_labels"]),
                              (maps, share["maps"], share["map_labels"])):
            for i, labels in zip(idx, got):
                if dst[i] is None:
                    dst[i] = labels
                elif not all(np.array_equal(a, b)
                             for a, b in zip(dst[i], labels)):
                    raise AssertionError(f"ranks disagree on item {i}")
    return {"frame_labels": frames, "map_labels": maps}


def probe_cuda_all_gather(mesh: DeviceMesh) -> str:
    """Whether this backend's ``all_gather`` takes a CUDA tensor: one
    tensor gathered over the data axis (2 ranks in a 2 x 4 mesh)."""
    import torch.distributed as dist

    if mesh.device.type != "cuda":
        raise ValueError("the probe needs a CUDA rank")
    t = torch.full((4,), float(mesh.rank), device=mesh.device)
    parts = [torch.empty_like(t) for _ in range(mesh.shape["data"])]
    try:
        dist.all_gather(parts, t, group=mesh.groups["data"])
    except RuntimeError as e:  # the answer, not a fallback
        return f"refused: {e}"
    want = [float(c * mesh.shape["model"] + mesh.coords["model"])
            for c in range(mesh.shape["data"])]
    got = [float(p[0]) for p in parts]
    if got != want:
        raise AssertionError(f"all_gather gave {got}, want {want}")
    return f"yes ({mesh.backend}, {len(parts)} ranks)"


# ----------------------------------------------------------------------
# Checks
# ----------------------------------------------------------------------


def assert_labels_near_ties(got: np.ndarray, want_labels: np.ndarray,
                            want_post: np.ndarray, ulps: int = 2) -> int:
    """Labels equal wherever the reference's top two classes are more than
    ``ulps`` float32 ulp apart; -> the count of differing labels."""
    diff = got != want_labels
    if diff.any():
        top2 = np.sort(want_post[diff], axis=-1)[:, -2:]
        gap = top2[:, 1] - top2[:, 0]
        tol = ulps * np.spacing(np.abs(top2[:, 1]).astype(np.float32))
        if (gap > tol).any():
            raise AssertionError(
                f"{int((gap > tol).sum())} of {int(diff.sum())} differing "
                "labels are not near-ties")
    return int(diff.sum())


def lattice_reference(lattice, unary, weight, blocks, n_iterations, device):
    """Single-device marginals ``[N, C]`` (``potts_mean_field_multi``) and
    the normalisation vector, both as numpy."""
    from ..models.crf import potts_mean_field_multi
    from ..models.lattice import attach_sorted_stream, lattice_filter, lattice_tensors

    lat = lattice_tensors(attach_sorted_stream(lattice), device)
    n = lattice.offsets.shape[0]
    raw = lattice_filter(torch.ones((n, 1), device=device), *lat,
                         lattice.num_vertices)[:, 0]
    norm = 1.0 / torch.sqrt(raw + 1e-20)
    q = potts_mean_field_multi(
        torch.as_tensor(unary, device=device), *lat, norm, weight, blocks,
        lattice.num_vertices, n_iterations)
    return q.cpu().numpy(), norm.cpu().numpy()


def probe_reference(n_ranks: int, device) -> tuple:
    """Part 1's single-process result: per layer, the batch's posteriors
    ``[B, H, W, C]`` and labels on the whole forest."""
    from ..features.extractor import FeatureConfig
    from ..pipelines.single_frame import SingleFramePipeline

    shape = mesh_shape(n_ranks)
    forest, stacks = probe_inputs(shape["data"], shape["model"])
    ref = SingleFramePipeline(
        FeatureConfig(patch_size=15, patch_size_reduce=5), forest, 2, device,
        fill_value=0.0,
    ).run_batch_stacked(*stacks)
    return ([np.stack([r.posteriors[li].cpu().numpy() for r in ref])
             for li in range(2)],
            [np.stack([r.labels[li].cpu().numpy() for r in ref])
             for li in range(2)])


def check_frames(got_posteriors, got_labels, want_posteriors, want_labels) -> int:
    """Posteriors within rtol 1e-6, labels equal except near-ties (per
    layer); -> the count of differing labels."""
    differ = 0
    for gp, gl, wp, wl in zip(got_posteriors, got_labels, want_posteriors,
                              want_labels):
        np.testing.assert_allclose(gp, wp, rtol=1e-6)
        differ += assert_labels_near_ties(gl, wl, wp)
    return differ


def check_fields(fields: dict, want: np.ndarray, variants: Sequence[str]) -> float:
    """Each variant within rtol 2e-4 / atol 2e-5; -> the largest error."""
    err = 0.0
    for v in variants:
        np.testing.assert_allclose(fields[v], want, rtol=2e-4, atol=2e-5,
                                   err_msg=v)
        err = max(err, float(np.abs(fields[v] - want).max()))
    return err


def check_streaming(shares: Sequence[dict], case: dict, device) -> None:
    """Part 5: the data ranks' labels equal the worker path's bit for bit."""
    got = gathered_streaming(shares, len(case["rgbs"]), len(case["clouds"]))
    want = streaming_reference(case, device)
    for key in ("frame_labels", "map_labels"):
        for i, (a_list, b_list) in enumerate(zip(got[key], want[key])):
            for a, b in zip(a_list, b_list):
                if not np.array_equal(a, b):
                    raise AssertionError(f"part 5: {key} {i} differ")


# Parts 3 and 4's trainer, the JAX dry run's.
TRAIN_CONFIG = dict(num_trees=2, max_depth=5, min_split_examples=10, seed=7)


def check_fused_forest(xs: np.ndarray, ys: np.ndarray, device):
    """Part 4: ``learn``'s fused forest against the tree loop
    (``grow_tree`` per tree) on the same data, every array bit-equal; ->
    the fused forest."""
    from ..models.forest import build_forest
    from ..train.forest_trainer import ForestTrainer, TrainerConfig

    trainer = ForestTrainer(TrainerConfig(**TRAIN_CONFIG), device)
    fused = trainer.learn(xs, ys[:, None], class_counts=[3], progress=False)
    data = trainer.prepare(xs, ys[:, None], class_counts=[3])
    loop = build_forest(
        [trainer.grow_tree(data, t) for t in range(trainer.config.num_trees)],
        [3], multi_label=False)
    for f in ("split_feature", "threshold", "left_child", "leaf_hist"):
        if not np.array_equal(getattr(fused, f), getattr(loop, f)):
            raise AssertionError(f"part 4: the fused forest's {f} differs "
                                 "from the tree loop's")
    return fused


def dryrun(n_ranks: int = 8, device: str = "cuda", timeout: float = 300.0) -> None:
    """Run parts 1, 2, 2b, 2c, 3, 4 and 5 and raise on the first mismatch."""
    from ..device import resolve_device
    from ..models.lattice import build_lattice
    from ..train.forest_trainer import ForestTrainer, TrainerConfig
    from .tree_parallel import learn_forest_parallel

    dev = resolve_device(device)
    if dev.type == "cuda":
        from ..csrc.build import load_kernels

        load_kernels()  # built once here; the ranks load it
    shape = mesh_shape(n_ranks)
    inp = crf_inputs()
    lattice = build_lattice(inp["feats"])
    lattice2 = build_lattice(inp["feats2"])
    want, norm = lattice_reference(lattice, inp["unary"], 3.0, (5,), 4, dev)
    want2, _ = lattice_reference(lattice2, inp["unary2"], 3.0, (5,), 4, dev)
    case = streaming_inputs(shape["data"])

    t0 = time.perf_counter()
    out = run_world(n_ranks, [
        Call("parallel.mesh:shard_batch_pipeline"),
        Call("parallel.dryrun:mean_field_variants",
             ("model", inp["unary"], lattice, norm, 3.0, (5,), 4)),
        Call("parallel.dryrun:mean_field_variants",
             ("model", inp["unary2"], lattice2, None, 3.0, (5,), 4),
             {"variants": ("auto",)}),
        Call("parallel.dryrun:streaming_share", (case,)),
    ], device=device, timeout=timeout)
    world_s = time.perf_counter() - t0

    # 1. The frame step against the single process on the whole forest.
    want_p, want_l = probe_reference(n_ranks, dev)
    for rank_out in out:
        check_frames(*rank_out[0], want_p, want_l)

    # 2-2c. The sharded mean fields against the single-device one.
    for rank_out in out:
        fields, auto2 = rank_out[1], rank_out[2]
        check_fields(fields, want, ("points", "transposed", "vertex", "auto"))
        check_fields(auto2, want2, ("auto",))
        if (fields["variant"], auto2["variant"]) != ("replicated", "vertex"):
            raise AssertionError(
                f"auto chose {fields['variant']} / {auto2['variant']}, want "
                "replicated on the random cloud, vertex on the trajectory")

    # 3. Tree-parallel training equals the sequential trainer.
    cfg = TrainerConfig(**TRAIN_CONFIG)
    par = learn_forest_parallel(cfg, inp["xs"], inp["ys"], class_counts=[3],
                                devices=[dev, dev])
    seq = ForestTrainer(cfg, dev).learn(inp["xs"], inp["ys"][:, None],
                                        class_counts=[3], progress=False)
    for f in ("split_feature", "threshold", "left_child", "leaf_hist"):
        np.testing.assert_array_equal(getattr(par, f), getattr(seq, f))

    # 4. The fused forest equals the tree loop.
    check_fused_forest(inp["xs"], inp["ys"], dev)

    # 5. The streaming step's shares against the single-process worker path.
    check_streaming([o[3] for o in out], case, dev)

    print(
        f"dryrun: {n_ranks} ranks ({shape}) on {device}: sharded batch + "
        "sharded CRF (points-major / transposed / vertex-sharded + "
        f"auto-selection {out[0][1]['variant']} / {out[0][2]['variant']}) + "
        "tree-parallel training (== sequential) + fused forest (== tree "
        "loop) + sharded streaming step "
        f"(== worker path) OK; world {world_s:.3f} s"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
    dryrun(args.ranks, args.device, args.timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())

