"""The port's stage profilers of the main path on the CPU, at small sizes.

``rovinasemanticsegmentation_tpu_torch/scripts/{exp_lattice,exp_filter,
profile_normals,profile_map,profile_slope}.py`` time the stages of the
lattice build, the filter, the normals, the map path and the frame path. Here,
on inputs made with numpy from seeds (the bench's map of 2000 points, 60x80
frames, 2 mean-field iterations):

- each stage, called as the script calls it, against the JAX package function
  that the JAX script of the same name times, on the same inputs (JAX on the
  CPU; Pallas in interpret mode or through its plain reference), each with
  its stated tolerance from the port's contracts;
- each script's stages composed against its production call, bit for bit;
- each script's ``main`` with ``--device cpu``, which must print every
  stage's line with every key and a summary whose checks hold.

The JAX *package* is imported, never the JAX ``scripts/`` (they set a
compile-cache directory when imported).
"""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovinasemanticsegmentation_tpu.models import forest as jforest
from rovinasemanticsegmentation_tpu.models import lattice as JL
from rovinasemanticsegmentation_tpu.ops import color as jcolor
from rovinasemanticsegmentation_tpu.ops import geometry as jgeom
from rovinasemanticsegmentation_tpu.ops import normals as jnormals
from rovinasemanticsegmentation_tpu.ops import patches as jpatches
from rovinasemanticsegmentation_tpu.ops.patches_pallas import (
    extract_patches_pallas,
)
from rovinasemanticsegmentation_tpu.pipelines import local_map as jlm
from rovinasemanticsegmentation_tpu.pipelines import single_frame as jsf
from rovinasemanticsegmentation_tpu_torch.models.lattice import (
    _blur_neighbors_sort,
    _neighbor_tables,
    build_lattice_device,
    lattice_filter_t,
)
from rovinasemanticsegmentation_tpu_torch.ops.feature_rows import unpack_rows
from rovinasemanticsegmentation_tpu_torch.ops.normals import normal_angles_grid
from rovinasemanticsegmentation_tpu_torch.pipelines.local_map import (
    LocalMapPipeline,
)
from rovinasemanticsegmentation_tpu_torch.scripts import (
    exp_filter,
    exp_lattice,
    profile_map,
    profile_normals,
    profile_slope,
    stage_timing,
)

torch.set_num_threads(2)

CPU = torch.device("cpu")
POINTS = 2000
FRAME = (60, 80)
ITERATIONS = 2
BATCH = 2
BUCKET = stage_timing.MAP_BUCKET
FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "resources", "bench_forest.dat")
# Normals: the port's float64 integral images against JAX run in float64
# (2 float32 ulps near pi/2), masks against JAX's float32 function.
ANGLE_TOL = 2.4e-7
# Lattice filter: f32 summation order only (queue 3; the dry run's bound).
FILTER_RTOL, FILTER_ATOL = 2e-4, 2e-5
# Map labels: >= 99.9% equal (queue 3), the rest near-ties of the marginals.
MAP_AGREE = 0.999
# Forest posteriors: rtol 1e-6 (test_cpp_parity.py).
FOREST_RTOL = 1e-6


def _np(t):
    return t.detach().cpu().numpy()


def _stage(stages, name):
    return next(s for s in stages if s.name == name)


def _call(stages, name, i=0):
    s = _stage(stages, name)
    return s.run(*s.make_input(i))


# ----------------------------------------------------------------------
# Lattice build and filter (exp_lattice, exp_filter)
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def lattice():
    feats = stage_timing.map_features(POINTS, CPU)
    f = _np(feats)
    jbuilt = JL.build_lattice_device(jnp.asarray(f), m_bucket=BUCKET)
    assert int(jbuilt[-1]) <= BUCKET
    return feats, f, jbuilt


def _jax_dedup(f):
    n, d = f.shape
    s = n * (d + 1)
    keys, bary = jax.jit(JL._embed_simplex)(jnp.asarray(f))
    kflat = keys.reshape(s, d)
    packs = JL._pack_keys16(kflat, d)
    return JL._dedup_sorted(packs, kflat, bary, n, d, BUCKET,
                            -(-s // 128) * 128)


def test_embed_stage_bit_equal_to_jax(lattice):
    feats, f, _ = lattice
    keys, bary = jax.jit(JL._embed_simplex)(jnp.asarray(f))
    got = _call(exp_lattice.stages(feats, BUCKET), "embed")
    np.testing.assert_array_equal(_np(got[0]), np.asarray(keys))
    np.testing.assert_array_equal(_np(got[1]), np.asarray(bary))


def test_dedup_stage_equal_to_jax(lattice):
    """Stream, segments, offsets, m and the per-vertex keys equal index for
    index (both number vertices lexicographically; both sorts are stable)."""
    feats, f, _ = lattice
    got, _ = _call(exp_lattice.stages(feats, BUCKET), "dedup")
    want = _jax_dedup(f)
    for k, name in enumerate(("sorted_points", "sorted_weights", "seg_starts",
                              "seg_ends", "offsets_t", "m")):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]),
                                      err_msg=name)
    for g, w in zip(got[6] + got[7], want[6] + want[7]):  # uq, ucoord
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_full_stage_equal_to_jax(lattice):
    """Tables equal; barycentric weights within rtol 1e-5 / atol 1e-6 (as
    tests/test_torch_lattice.py holds the whole build)."""
    feats, _, jbuilt = lattice
    got = _call(exp_lattice.stages(feats, BUCKET), "full")
    for k in (0, 2, 3, 4, 6, 7, 8):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(jbuilt[k]))
    np.testing.assert_allclose(_np(got[5]), np.asarray(jbuilt[5]),
                               rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def filter_stages(lattice):
    feats, _, _ = lattice
    _, values, verts = exp_filter.inputs(POINTS, CPU)
    built = build_lattice_device(feats, BUCKET)
    return exp_filter.stages(feats, values, verts, built, BUCKET), values


@pytest.mark.parametrize("i", [0, 5])
def test_neighbour_stage_equal_to_jax(lattice, filter_stages, i):
    """Call i shifts every vertex's coordinates by i: the tables stay the
    JAX package's ``_blur_neighbors_sort`` tables of the unshifted keys."""
    f = lattice[1]
    stages, _ = filter_stages
    n1, n2 = _call(stages, exp_filter.NEIGH[3], i)
    want = _jax_dedup(f)
    jn1, jn2 = JL._blur_neighbors_sort(want[6], want[7], want[5], BUCKET,
                                       f.shape[1])
    np.testing.assert_array_equal(_np(n1), np.asarray(jn1))
    np.testing.assert_array_equal(_np(n2), np.asarray(jn2))


def test_filter_stage_within_contract_of_jax(lattice, filter_stages):
    _, _, jbuilt = lattice
    stages, values = filter_stages
    got = _call(stages, "filter (whole)")
    want = JL.lattice_filter_t(jnp.asarray(_np(values)), *jbuilt[:8], BUCKET)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=FILTER_RTOL,
                               atol=FILTER_ATOL)


def test_lattice_chains_bit_equal_to_production(lattice, filter_stages):
    feats, _, _ = lattice
    built = build_lattice_device(feats, BUCKET)
    assert stage_timing.same(exp_lattice.chain(feats, BUCKET), built)
    (_, _, _, _, _, m, uq, ucoord, _), _ = exp_lattice.dedup(feats, BUCKET)
    back = exp_filter.neighbor_steps(uq, ucoord, m, BUCKET, 3)
    assert stage_timing.same(_neighbor_tables(back, m, BUCKET, len(ucoord)),
                             _blur_neighbors_sort(uq, ucoord, m, BUCKET,
                                                  len(ucoord)))
    _, values = filter_stages
    assert torch.equal(exp_filter.filter_parts(values, built[:8], BUCKET),
                       lattice_filter_t(values, *built[:8], BUCKET))
    assert all(exp_filter.checks_of(feats, values, built, BUCKET).values())


# ----------------------------------------------------------------------
# Normals (profile_normals)
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def normals_inputs():
    depth, kinv = profile_normals.frame(*FRAME, CPU)
    return depth, kinv, profile_normals.stages(depth, kinv)


def _check_angles(got, points):
    """Masks equal to JAX's float32 function, angles within ANGLE_TOL of
    JAX run in float64."""
    want32 = np.asarray(jnormals.normal_angles_grid(
        jnp.asarray(points), 2, chamfer_variant="iter"))
    with jax.enable_x64(True):
        want64 = np.asarray(jnormals.normal_angles_grid(
            jnp.asarray(points.astype(np.float64)), 2, chamfer_variant="iter"))
    np.testing.assert_array_equal(got == -2.0, want32 == -2.0)
    valid = got != -2.0
    assert valid.sum() > 100
    assert np.abs(got[valid].astype(np.float64) - want64[valid]).max() \
        <= ANGLE_TOL


def test_backproject_stage_equal_to_jax(normals_inputs):
    depth, kinv, stages = normals_inputs
    got = _call(stages, "backproject", 3)
    d = np.where(_np(depth) > 0, _np(depth) + 3, _np(depth))
    want = jgeom.backproject(jnp.asarray(d.astype(np.uint16)),
                             jnp.asarray(kinv.astype(np.float32)), jnp.eye(3),
                             jnp.zeros(3), jnp.float32(0.5), jnp.float32(15.0))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("stage,saturation", [
    ("iterated chamfer", 10.0), ("exact chamfer (full-height passes)", None)])
def test_chamfer_stages_bit_equal_to_jax(normals_inputs, stage, saturation):
    _, _, stages = normals_inputs
    s = _stage(stages, stage)
    (change,) = s.make_input(4)
    want = jnormals.chamfer_distance_map(jnp.asarray(_np(change)),
                                         saturation=saturation,
                                         variant="iter")
    np.testing.assert_array_equal(_np(s.run(change)), np.asarray(want))


def test_normals_stage_within_contract_of_jax(normals_inputs):
    _, _, stages = normals_inputs
    s = _stage(stages, "normals (whole)")
    (points,) = s.make_input(0)
    _check_angles(_np(s.run(points)), _np(points))


def test_normals_chain_bit_equal_to_production(normals_inputs):
    depth, kinv, _ = normals_inputs
    points = profile_normals.to_points(depth, kinv)
    assert torch.equal(profile_normals.chain(points),
                       normal_angles_grid(points, 2))


# ----------------------------------------------------------------------
# Map path (profile_map)
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def maps():
    m = profile_map.MapInputs(POINTS, FRAME, ITERATIONS, CPU)
    return m, m.stages()


def _jax_posteriors(m):
    return tuple((tuple(jnp.asarray(p) for p in layers),)
                 for layers in m.posteriors)


def _agreement(got, want):
    return np.mean(np.concatenate([_np(g) == np.asarray(w)
                                   for g, w in zip(got, want)]))


def test_fuse_stage_equal_to_jax(maps):
    """The winners' posteriors summed in node order on both sides: within
    1e-6 relative (float32 sums of the same terms)."""
    m, stages = maps
    got = _call(stages, "fuse_unaries")
    h, w = FRAME
    want = jlm._fuse_nodes(
        jnp.asarray(m.points), jnp.asarray(m.poses[..., :3]),
        jnp.asarray(m.poses[..., 3]), jnp.asarray(m.projector.intrinsics),
        jnp.float32(0.5), jnp.float32(15.0), _jax_posteriors(m),
        height=h, width=w, num_points=POINTS)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert (_np(got) != 0).any()


def test_crf_stage_agrees_with_jax(maps):
    m, stages = maps
    s = _stage(stages, f"crf_labels_multi ({ITERATIONS} it)")
    (unaries,) = s.make_input(0)
    feats = m.features(*m.tensors())
    jbuilt = JL.build_lattice_device(jnp.asarray(_np(feats)), m_bucket=BUCKET)
    want = jlm._crf_labels_multi(
        jnp.asarray(_np(unaries)), *jbuilt[:8],
        jnp.float32(m.crf.kernel_weight), tuple(m.blocks), BUCKET,
        ITERATIONS, tuple(m.unknown))
    assert _agreement(s.run(unaries), want) >= MAP_AGREE


def test_map_whole_stage_agrees_with_jax(maps):
    m, stages = maps
    labels, _ = _call(stages, "map_fused (whole)")
    h, w = FRAME
    want, jm = jlm._map_fused(
        jnp.asarray(m.points), jnp.asarray(m.rgb), jnp.asarray(m.poses),
        jnp.asarray(m.projector.intrinsics), _jax_posteriors(m),
        height=h, width=w, num_points=POINTS, blocks=tuple(m.blocks),
        m_bucket=BUCKET, n_iterations=ITERATIONS,
        unknown_labels=tuple(m.unknown), min_distance=0.5, max_distance=15.0,
        xyz_kernel=m.crf.xyz_kernel, rgb_kernel=m.crf.rgb_kernel,
        kernel_weight=m.crf.kernel_weight)
    assert int(jm) <= BUCKET
    assert _agreement(labels, want) >= MAP_AGREE


def test_map_chain_bit_equal_to_production(maps):
    m, _ = maps
    points, rgb = m.tensors()
    labels, count = m.whole(points, rgb)
    assert stage_timing.same(m.chain(points, rgb), labels)
    assert int(count) <= BUCKET


def test_bucket_is_the_map_pipelines(maps):
    m, _ = maps
    pipeline = LocalMapPipeline(m.projector, m.blocks, m.unknown, CPU)
    assert pipeline._m_bucket == BUCKET


# ----------------------------------------------------------------------
# Frame path (profile_slope)
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def frames():
    f = profile_slope.FrameInputs(BATCH, FRAME, CPU)
    return f, f.stages()


def test_lab_stage_bit_equal_to_jax(frames):
    f, stages = frames
    got = _call(stages, "lab+pad", 7)
    rgb = _np(f.rgb) ^ 7
    for b, (padded, _) in enumerate(got):
        want = jpatches.reflect_pad_image(
            jcolor.rgb_to_lab8(jnp.asarray(rgb[b])), f.cfg.patch_size)
        np.testing.assert_array_equal(_np(padded), np.asarray(want))


def test_patches_stage_bit_equal_to_jax(frames):
    """Kernel A's plain version into the rows, against the Pallas kernel in
    interpret mode."""
    f, stages = frames
    s = _stage(stages, "patches (A + pack_lab)")
    padded, grids, rows = s.make_input(2)
    s.run(padded, grids, rows)
    r = f.cfg.patch_size_reduce
    for b in range(BATCH):
        want = extract_patches_pallas(
            jnp.asarray(_np(padded[b])), jnp.asarray(_np(grids[b])),
            patch_size=f.cfg.patch_size, reduce_size=r, stride=2,
            interpret=True)
        got = rows[b * f.points : (b + 1) * f.points, : 3 * r * r]
        np.testing.assert_array_equal(
            _np(got), np.asarray(want).reshape(f.points, 3 * r * r))


def test_normals_tail_stage_within_contract_of_jax(frames):
    f, stages = frames
    s = _stage(stages, "backproject+normals")
    depth_f, depth_m = s.make_input(0)
    parts = s.run(depth_f, depth_m)
    kinv = _np(f.calib[0][0])
    for b in range(BATCH):
        points = jgeom.backproject(
            jnp.asarray(_np(f.depth[b]).astype(np.uint16)), jnp.asarray(kinv),
            jnp.eye(3), jnp.zeros(3), jnp.float32(0.5), jnp.float32(15.0))
        _check_angles(_np(parts[b][2]).reshape(-1, f.pipeline.grid_shape(
            *FRAME)[1]), np.asarray(points))


def test_descent_stage_within_contract_of_jax(frames):
    f, stages = frames
    s = _stage(stages, "descent (B)")
    (rows,) = s.make_input(0)
    _, post = s.run(rows)
    jf = jforest.load_forest(FIXTURE, class_counts=[8, 9])
    want = jforest.ForestPredictor(jf).log_posterior(
        jnp.asarray(_np(unpack_rows(rows, f.layout))))
    np.testing.assert_allclose(_np(post), np.asarray(want), rtol=FOREST_RTOL)


def test_resize_stage_equal_to_jax(frames):
    """Resize and argmax of the same posteriors: maps within 1e-6, labels
    equal except at exact float32 ties of the top two classes."""
    f, stages = frames
    s = _stage(stages, "resize+argmax")
    post, masks = s.make_input(3)
    got = s.run(post, masks)
    for b in range(BATCH):
        posteriors, labels = jsf._posterior_maps(
            jnp.asarray(_np(post[b * f.points : (b + 1) * f.points])),
            jnp.asarray(_np(masks[b])), jnp.zeros(FRAME), 2, (8, 9), 0.0,
            *FRAME)
        for li in range(2):
            want = np.asarray(posteriors[li])
            np.testing.assert_allclose(_np(got[b].posteriors[li]), want,
                                       rtol=1e-6, atol=1e-6)
            top = np.sort(want, axis=-1)[..., -2:]
            tie = top[..., 1] == top[..., 0]
            assert tie.mean() < 0.01
            np.testing.assert_array_equal(_np(got[b].labels[li])[~tie],
                                          np.asarray(labels[li])[~tie])


def test_frame_chain_bit_equal_to_production(frames):
    f, _ = frames
    assert profile_slope.same_results(f.chain()[0], f.production())


# ----------------------------------------------------------------------
# Every script: inputs that change, the end-to-end run, the profile reading
# ----------------------------------------------------------------------


def _all_stages(lattice, filter_stages, normals_inputs, maps, frames):
    feats = lattice[0]
    return (exp_lattice.stages(feats, BUCKET) + filter_stages[0]
            + normals_inputs[2] + maps[1] + frames[1])


def _differs(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return not torch.equal(a, b)
    if isinstance(a, (list, tuple)):
        return any(_differs(x, y) for x, y in zip(a, b))
    return False


def test_every_stage_input_changes_with_the_call(lattice, filter_stages,
                                                 normals_inputs, maps, frames):
    for s in _all_stages(lattice, filter_stages, normals_inputs, maps, frames):
        if s.fused_into is not None:
            continue
        inputs = [s.make_input(i) for i in range(4)]
        for i in range(3):
            assert _differs(inputs[i], inputs[i + 1]), (s.name, i)


STAGE_KEYS = {"script", "stage", "unit", "device", "wall_ms", "wall_ms_runs",
              "calls", "device_ms", "busy_ms", "activities", "idle_share",
              "top_ops"}

MAINS = {
    "exp_lattice": (exp_lattice, ["--points", str(POINTS)]),
    "exp_filter": (exp_filter, ["--points", str(POINTS)]),
    "profile_normals": (profile_normals, ["--frame", "60x80"]),
    "profile_map": (profile_map, ["--points", str(POINTS), "--frame", "60x80",
                                  "--iterations", str(ITERATIONS)]),
    "profile_slope": (profile_slope, ["--frame", "60x80", "--batch", "2"]),
}


@pytest.mark.parametrize("script", sorted(MAINS))
def test_main_on_cpu_prints_every_stage(script, capsys):
    module, argv = MAINS[script]
    assert module.main(argv + ["--device", "cpu", "--reps", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("cpu: no card")
    lines = [json.loads(line) for line in out[1:]]
    summary = lines[-1]
    assert summary["summary"] and summary["ok"] and summary["script"] == script
    assert all(summary["checks"].values()) and summary["checks"]
    assert [line["stage"] for line in lines[:-1]] == summary["stages"]
    for line in lines[:-1]:
        assert STAGE_KEYS <= set(line), line
        assert line["device"] == "cpu" and line["device_ms"] is None
        assert (line["wall_ms"] is None) == ("fused_into" in line)
    if "m" in summary:
        assert 0 < summary["m"] <= summary["bucket"] == BUCKET


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        exp_lattice.main(["--points", "50"])


def _event(name, start, end, device="CUDA"):
    return SimpleNamespace(
        name=name, device_type=SimpleNamespace(name=device),
        time_range=SimpleNamespace(start=start, end=end,
                                   elapsed_us=lambda: end - start))


def test_summarize_device_counts_per_call():
    events = [_event("roll", 0, 10), _event("roll", 5, 15),
              _event("index", 20, 30), _event("aten::roll", 0, 40, "CPU")]
    got = stage_timing.summarize_device(events, calls=2)
    assert got["device_ms"] == pytest.approx(0.015)  # 30 us over 2 calls
    assert got["busy_ms"] == pytest.approx(0.0125)  # the union: 25 us
    assert got["activities"] == 1.5
    assert got["top_ops"][0] == {"name": "roll", "ms": 0.01, "count": 1.0}
