"""PyTorch port vs JAX: the sharded paths of ``parallel/``.

The port's mesh is one process per device slot: one ``gloo`` world of 8 CPU
ranks (``parallel/launch.py``; a 2 x 4 data x model mesh), spawned once for
this file, runs the dry run's sharded paths and the sharded map pipeline on
seeded numpy inputs; each test holds one of its results against the JAX
package on the same inputs, JAX on its 8 virtual CPU devices where its own
suite runs the function (the points-major and vertex-sharded mean fields,
the frame step's single-frame function) and on one device otherwise. The
planner, pure NumPy in both packages, must give equal plans. The sharded map
pipeline is held against JAX's in ``test_torch_parallel_map.py``.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rovinasemanticsegmentation_tpu.models import crf as jcrf
from rovinasemanticsegmentation_tpu.models import forest as jforest
from rovinasemanticsegmentation_tpu.models import lattice as jlattice
from rovinasemanticsegmentation_tpu.parallel import mesh as jmesh
from rovinasemanticsegmentation_tpu.parallel import sharded_crf as jsharded_crf
from rovinasemanticsegmentation_tpu.parallel import sharded_lattice as jsharded
from rovinasemanticsegmentation_tpu.pipelines.single_frame import _single_frame_impl
from rovinasemanticsegmentation_tpu_torch.models.lattice import PermutohedralLattice
from rovinasemanticsegmentation_tpu_torch.parallel import dryrun
from rovinasemanticsegmentation_tpu_torch.parallel import sharded_lattice as tsharded
from rovinasemanticsegmentation_tpu_torch.parallel.launch import Call, run_world
from rovinasemanticsegmentation_tpu_torch.parallel.mesh import mesh_shape

RANKS = 8
WORLD_TIMEOUT = 300.0  # seconds; the world takes ~10 s on 8 idle cores
WEIGHT, ITERS, CLASSES = 3.0, 4, 5  # the dry run's mean field


def _port_lattice(jl) -> PermutohedralLattice:
    return PermutohedralLattice(jl.offsets, jl.barycentric, jl.blur_n1,
                                jl.blur_n2, jl.num_vertices, jl.dim)


def _surface_features():
    """``test_pipeline.py``'s 4000-point wavy surface at serving kernels."""
    rng = np.random.default_rng(9)
    n = 4000
    xy = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    z = (2.0 + 0.3 * np.sin(xy[:, 0] * 2) + 0.2 * xy[:, 1] ** 2).astype(
        np.float32)
    pts = np.concatenate([xy, z[:, None]], axis=1)
    rgbf = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return np.concatenate([pts / 0.5, rgbf / 4.0], axis=1).astype(np.float32)




@pytest.fixture(scope="module")
def inputs():
    inp = dryrun.crf_inputs()
    jl = jlattice.build_lattice(inp["feats"])
    jl2 = jlattice.build_lattice(inp["feats2"])
    raw = jlattice.lattice_filter(
        jnp.ones((jl.offsets.shape[0], 1), jnp.float32),
        jnp.asarray(jl.offsets), jnp.asarray(jl.barycentric),
        jnp.asarray(jl.blur_n1), jnp.asarray(jl.blur_n2), jl.num_vertices,
    )[:, 0]
    norm = np.asarray(1.0 / jnp.sqrt(raw + 1e-20))
    return dict(inp, jl=jl, jl2=jl2, norm=norm,
                case=dryrun.streaming_inputs(mesh_shape(RANKS)["data"]))


@pytest.fixture(scope="module")
def world(inputs):
    """Every rank's results of one 8-rank CPU world."""
    lat, lat2 = _port_lattice(inputs["jl"]), _port_lattice(inputs["jl2"])
    unary, norm = inputs["unary"], inputs["norm"]
    calls = {
        "probe": Call("parallel.mesh:shard_batch_pipeline"),
        "fields": Call("parallel.dryrun:mean_field_variants",
                       ("model", unary, lat, norm, WEIGHT, (CLASSES,), ITERS)),
        "fields_data": Call("parallel.dryrun:mean_field_variants",
                            ("data", unary, lat, norm, WEIGHT, (CLASSES,), ITERS),
                            {"variants": ("points",)}),
        "trajectory": Call("parallel.dryrun:mean_field_variants",
                           ("model", inputs["unary2"], lat2, None, WEIGHT,
                            (CLASSES,), ITERS), {"variants": ("auto",)}),
        "streaming": Call("parallel.dryrun:streaming_share", (inputs["case"],)),
        "modules": Call("parallel.launch:loaded_modules"),
    }
    out = run_world(RANKS, list(calls.values()), device="cpu",
                    timeout=WORLD_TIMEOUT)
    names = list(calls)
    return [dict(zip(names, rank_out)) for rank_out in out]


def _jax_single_device(jl, unary, norm, weight, iters):
    return np.asarray(jcrf.potts_mean_field(
        jnp.asarray(unary), jnp.asarray(jl.offsets), jnp.asarray(jl.barycentric),
        jnp.asarray(jl.blur_n1), jnp.asarray(jl.blur_n2), jnp.asarray(norm),
        jnp.float32(weight), jl.num_vertices, iters,
    ))


# ----------------------------------------------------------------------
# Pure checks
# ----------------------------------------------------------------------


@pytest.mark.parametrize("n", [8, 2, 1])
def test_mesh_shape_matches_jax(n):
    assert mesh_shape(n) == dict(jmesh.make_mesh(n).shape)


def _cloud_features(name):
    if name == "random":
        return dryrun.crf_inputs()["feats"]
    if name == "trajectory":
        return dryrun.trajectory_features()
    return _surface_features()


CLOUDS = ["random", "trajectory", "surface"]


@pytest.fixture(scope="module")
def plans():
    out = {}
    for name in CLOUDS:
        jl = jlattice.build_lattice(_cloud_features(name))
        d = mesh_shape(RANKS)["model"]
        out[name] = (jsharded.plan_sharded_lattice(jl, d),
                     tsharded.plan_sharded_lattice(_port_lattice(jl), d))
    return out


@pytest.mark.parametrize("cloud", CLOUDS)
def test_plan_equals_jax(plans, cloud):
    want, got = plans[cloud]
    for field in want.__dataclass_fields__:
        a, b = getattr(got, field), getattr(want, field)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        else:
            assert a == b, field


@pytest.mark.parametrize("cloud", CLOUDS)
def test_comm_volumes_and_choice_equal_jax(plans, cloud):
    want, got = plans[cloud]
    assert got.comms_per_filter == want.comms_per_filter
    assert got.replicated_comms_per_filter == want.replicated_comms_per_filter
    assert tsharded.choose_crf_variant(got) == jsharded.choose_crf_variant(want)


# ----------------------------------------------------------------------
# The world's results
# ----------------------------------------------------------------------


def _jax_probe():
    """JAX's frame-step probe (``parallel/mesh.py::shard_batch_pipeline``)
    on one device: its own forest, past-the-row splits included."""
    data, model = mesh_shape(RANKS)["data"], mesh_shape(RANKS)["model"]
    rng = np.random.default_rng(0)
    b, h, w = 2 * data, 24, 32
    rgb = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    depth = rng.integers(600, 14000, (b, h, w)).astype(np.uint16)
    kinv = np.tile(np.linalg.inv([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]]),
                   (b, 1, 1)).astype(np.float32)
    rot = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
    trans = np.zeros((b, 3), dtype=np.float32)
    forest = jforest.random_forest(rng, num_trees=max(4, model), depth=6,
                                   num_features=366, class_counts=[8, 9],
                                   max_nodes=63)
    rec, feat_bits = jforest.pack_node_records(
        forest.split_feature, forest.left_child, forest.threshold)
    static = dict(
        stride=2, patch_size=15, reduce_size=5, use_color_patch=True,
        use_depth=True, use_height=True, use_normal=True,
        max_depth=forest.max_depth, feat_bits=feat_bits,
        class_counts=tuple(forest.class_counts), fill_value=0.0,
        out_h=h, out_w=w,
    )
    one = partial(_single_frame_impl, **static)
    posteriors, labels = jax.jit(jax.vmap(
        lambda *a: one(*a, jnp.float32(0.5), jnp.float32(15.0),
                       jnp.asarray(rec), jnp.asarray(forest.leaf_hist))
    ))(rgb, depth, kinv, rot, trans)
    return ([np.asarray(p) for p in posteriors],
            [np.asarray(l) for l in labels])


def test_frame_step_matches_jax(world):
    want_p, want_l = _jax_probe()
    for rank_out in world:
        got_p, got_l = rank_out["probe"]
        for li in range(2):
            np.testing.assert_allclose(got_p[li], want_p[li], rtol=1e-6)
            dryrun.assert_labels_near_ties(got_l[li], want_l[li], want_p[li])


@pytest.mark.parametrize("axis", ["model", "data"])
def test_points_major_matches_jax_sharded(world, inputs, axis):
    jl = inputs["jl"]
    want = jsharded_crf.sharded_potts_mean_field(
        jmesh.make_mesh(RANKS), axis, inputs["unary"], jl, inputs["norm"],
        WEIGHT, ITERS)
    key = "fields" if axis == "model" else "fields_data"
    for rank_out in world:
        np.testing.assert_allclose(rank_out[key]["points"], want,
                                   rtol=2e-4, atol=2e-5)


def test_transposed_matches_jax_single_device(world, inputs):
    want = _jax_single_device(inputs["jl"], inputs["unary"], inputs["norm"],
                              WEIGHT, ITERS)
    for rank_out in world:
        np.testing.assert_allclose(rank_out["fields"]["transposed"], want,
                                   rtol=2e-4, atol=2e-5)


def test_vertex_sharded_matches_jax_sharded(world, inputs):
    want = jsharded.vertex_sharded_potts_mean_field(
        jmesh.make_mesh(RANKS), "model", inputs["unary"], inputs["jl"],
        WEIGHT, (CLASSES,), ITERS)
    for rank_out in world:
        np.testing.assert_allclose(rank_out["fields"]["vertex"], want,
                                   rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("cloud,variant", [("fields", "replicated"),
                                           ("trajectory", "vertex")])
def test_auto_choice_matches_jax(world, inputs, cloud, variant):
    jl, unary = ((inputs["jl"], inputs["unary"]) if cloud == "fields"
                 else (inputs["jl2"], inputs["unary2"]))
    plan = jsharded.plan_sharded_lattice(jl, mesh_shape(RANKS)["model"])
    assert jsharded.choose_crf_variant(plan) == variant
    norm = np.asarray(1.0 / jnp.sqrt(jlattice.lattice_filter(
        jnp.ones((jl.offsets.shape[0], 1), jnp.float32),
        jnp.asarray(jl.offsets), jnp.asarray(jl.barycentric),
        jnp.asarray(jl.blur_n1), jnp.asarray(jl.blur_n2), jl.num_vertices,
    )[:, 0] + 1e-20))
    want = _jax_single_device(jl, unary, norm, WEIGHT, ITERS)
    for rank_out in world:
        got = rank_out[cloud]
        assert got["variant"] == variant
        assert (got["halo_comms"], got["replicated_comms"]) == (
            plan.comms_per_filter, plan.replicated_comms_per_filter)
        np.testing.assert_allclose(got["auto"], want, rtol=2e-4, atol=2e-5)


def test_streaming_shares_equal_single_process(world, inputs):
    case = inputs["case"]
    got = dryrun.gathered_streaming([r["streaming"] for r in world],
                                    len(case["rgbs"]), len(case["clouds"]))
    want = dryrun.streaming_reference(case, "cpu")
    for key in ("frame_labels", "map_labels"):
        for a_list, b_list in zip(got[key], want[key]):
            for a, b in zip(a_list, b_list):
                np.testing.assert_array_equal(a, b)


def test_ranks_import_nothing_of_the_jax_package(world):
    for rank_out in world:
        bad = [m for m in rank_out["modules"]
               if m.split(".")[0] in ("jax", "rovinasemanticsegmentation_tpu")]
        assert bad == []
