"""PyTorch port vs JAX: ``LocalMapPipeline(mesh=...)``.

One ``gloo`` world of 8 CPU ranks (a 2 x 4 data x model mesh) labels
``test_fusion.py``'s two mesh maps, a dense cluster and a long smooth
trajectory, from their unaries, with the mean field sharded over the model
axis; JAX's ``LocalMapPipeline(mesh=make_mesh(8))`` labels the same maps on
its 8 virtual CPU devices. The variant chosen must be JAX's (replicated on
the cluster, vertex-sharded on the trajectory) and the labels must agree on
at least 99.9% of the points. The whole map path on the mesh (fusion of a
keyframe's posteriors, then the sharded mean field) is held against one
process's on the cluster.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from rovinasemanticsegmentation_tpu.parallel import mesh as jmesh
from rovinasemanticsegmentation_tpu.pipelines import local_map as jlocal_map
from rovinasemanticsegmentation_tpu_torch.fusion.projector import MultiProjector
from rovinasemanticsegmentation_tpu_torch.parallel.launch import Call, run_world
from rovinasemanticsegmentation_tpu_torch.pipelines.local_map import (
    CrfParams,
    LocalMapPipeline,
    MapNodeFrames,
)
from rovinasemanticsegmentation_tpu_torch.utils.calibration import Calibration

from test_fusion import simple_projector

RANKS = 8
WORLD_TIMEOUT = 300.0  # seconds; the world takes ~10 s on 8 idle cores
MAP_CRF = dict(use_dense_crf=True, iterations=4)
VARIANTS = {"cluster": "replicated", "trajectory": "vertex"}


def _fusion_maps():
    """``test_fusion.py``'s two mesh clouds (a dense cluster, a long smooth
    trajectory) with their unaries, in its draw order."""
    rng = np.random.default_rng(3)

    def unaries_for(n):
        return [rng.normal(size=(n, 3)).astype(np.float32) * 2,
                rng.normal(size=(n, 4)).astype(np.float32) * 2]

    n = 203
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 2
    rgb = np.clip(rng.normal(size=(n, 3)) * 0.25 + 0.5, 0, 1).astype(np.float32)
    maps = {"cluster": (pts, rgb, unaries_for(n))}
    n = 4096
    t = np.linspace(0, 400, n)
    pts = np.stack([t * 0.5, 3 * np.sin(t * 0.2), 4.0 + 3 * np.cos(t * 0.13)],
                   axis=1).astype(np.float32)
    rgb = np.stack([np.abs(np.sin(t * 0.01)), np.abs(np.sin(t * 0.07)),
                    np.abs(np.cos(t * 0.03))], axis=1).astype(np.float32)
    maps["trajectory"] = (pts, rgb, unaries_for(n))
    return maps


@pytest.fixture(scope="module")
def maps():
    return _fusion_maps()


def _port_projector():
    """``test_fusion.py``'s ``simple_projector()`` in the port."""
    h, w = 20, 24
    calib = Calibration(
        intrinsic=np.array([[20.0, 0, w / 2], [0, 20.0, h / 2], [0, 0, 1]]),
        rotation=np.eye(3), translation=np.zeros(3))
    return MultiProjector.from_calibrations([calib], h, w, min_distance=0.5,
                                            max_distance=15.0)


def _node_posteriors():
    """One keyframe's per-layer posteriors for the cluster map."""
    rng = np.random.default_rng(5)
    return [rng.normal(size=(20, 24, c)).astype(np.float32) for c in (3, 4)]


@pytest.fixture(scope="module")
def world(maps):
    crf, proj = CrfParams(**MAP_CRF), _port_projector()
    calls = [
        Call("parallel.dryrun:map_labels",
             (proj, pts, rgb, [3, 4], [2, 3], crf), {"unaries": u})
        for pts, rgb, u in maps.values()
    ]
    pts, rgb, _ = maps["cluster"]
    node = MapNodeFrames(pose=np.eye(4), posteriors=[_node_posteriors()])
    calls.append(Call("parallel.dryrun:map_labels",
                      (proj, pts, rgb, [3, 4], [2, 3], crf), {"nodes": [node]}))
    out = run_world(RANKS, calls, device="cpu", timeout=WORLD_TIMEOUT)
    return [dict(zip([*maps, "run"], rank_out)) for rank_out in out]


def _jax_pipeline():
    return jlocal_map.LocalMapPipeline(
        simple_projector(), [3, 4], [2, 3],
        crf=jlocal_map.CrfParams(**MAP_CRF), mesh=jmesh.make_mesh(RANKS))


def _assert_agree(got, want):
    for g, w in zip(got, want):
        agree = (g == w).mean()
        assert agree >= 0.999, f"labels agree on {agree:.4%}"


@pytest.mark.parametrize("name", ["cluster", "trajectory"])
def test_map_pipeline_matches_jax_mesh(world, maps, name):
    pts, rgb, u = maps[name]
    jp = _jax_pipeline()
    want = jp.label_map(pts, rgb, [jnp.asarray(x) for x in u])
    for rank_out in world:
        got = rank_out[name]
        assert got["variant"] == jp.last_crf_variant == VARIANTS[name]
        _assert_agree(got["labels"], want)


def test_map_run_matches_single_process(world, maps):
    """The mesh branch of ``run_device`` (fusion, then the sharded mean
    field) against one process's ``run_device`` with the host lattice."""
    pts, rgb, _ = maps["cluster"]
    single = LocalMapPipeline(_port_projector(), [3, 4], [2, 3], "cpu",
                              crf=CrfParams(**MAP_CRF), use_device_lattice=False)
    node = MapNodeFrames(pose=np.eye(4), posteriors=[_node_posteriors()])
    want = [l.numpy() for l in single.run_device(pts, rgb, [node])]
    for rank_out in world:
        assert rank_out["run"]["variant"] == VARIANTS["cluster"]
        _assert_agree(rank_out["run"]["labels"], want)
