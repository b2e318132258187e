"""PyTorch port vs JAX reference: the dense CRF of the local-map path.

The mean field, the labels with their 2/C floor and overflow poisoning, and
``LocalMapPipeline`` with ``use_dense_crf`` on, held against the JAX
package on the same numpy inputs (JAX on the CPU). The frame posteriors
that feed the map path come from the JAX single-frame pipeline (Pallas
descent in interpret mode), as in ``__graft_entry__._dryrun_streaming_fused``.
"""

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rovinasemanticsegmentation_tpu.features.extractor import (
    FeatureConfig as JFeatureConfig,
)
from rovinasemanticsegmentation_tpu.fusion.projector import (
    MultiProjector as JMultiProjector,
)
from rovinasemanticsegmentation_tpu.models import lattice as JL
from rovinasemanticsegmentation_tpu.models.crf import (
    potts_mean_field_multi_t as jax_mean_field,
)
from rovinasemanticsegmentation_tpu.models.forest import random_forest
from rovinasemanticsegmentation_tpu.pipelines import local_map as jlm
from rovinasemanticsegmentation_tpu.pipelines.single_frame import (
    SingleFramePipeline as JSingleFramePipeline,
)
from rovinasemanticsegmentation_tpu.utils.calibration import Calibration
from rovinasemanticsegmentation_tpu_torch.fusion.projector import MultiProjector
from rovinasemanticsegmentation_tpu_torch.models.crf import (
    potts_mean_field_multi_t,
)
from rovinasemanticsegmentation_tpu_torch.pipelines import local_map as tlm

torch.set_num_threads(2)

BUCKET = 1 << 12
N_POINTS = 600


def _tensors(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.fixture(scope="module")
def lattice():
    """A JAX device build over a room-scale coloured cloud, and its norm."""
    rng = np.random.default_rng(3)
    pts = rng.uniform([-3.0, -1.5, 0.5], [3.0, 1.5, 6.0], (N_POINTS, 3))
    rgb = rng.uniform(0.0, 1.0, (N_POINTS, 3))
    feats = np.concatenate([pts * 0.5, rgb * 4.0], axis=1).astype(np.float32)
    built = JL.build_lattice_device(jnp.asarray(feats), m_bucket=BUCKET)
    assert int(built[-1]) <= BUCKET
    raw = JL.lattice_filter_t(jnp.ones((1, N_POINTS)), *built[:8], BUCKET)[0]
    norm = np.asarray(1.0 / jnp.sqrt(raw + 1e-20))
    return built[:8], norm


def _unaries(blocks, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N_POINTS, sum(blocks))) * 3.0).astype(np.float32)


@pytest.mark.parametrize("iterations", [3, 10])
@pytest.mark.parametrize("blocks", [(3, 4), (8, 9)])
def test_mean_field_matches_jax(lattice, blocks, iterations):
    built, norm = lattice
    u = _unaries(blocks, sum(blocks) + iterations)
    want = np.asarray(jax_mean_field(
        jnp.asarray(-u.T), *built, jnp.asarray(norm), jnp.float32(10.0),
        blocks, BUCKET, iterations,
    ))
    got = potts_mean_field_multi_t(
        torch.from_numpy(-u.T), *_tensors(built), torch.from_numpy(norm.copy()),
        10.0, blocks, BUCKET, iterations,
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    for q in np.split(got, np.cumsum(blocks)[:-1]):
        np.testing.assert_allclose(q.sum(axis=0), 1.0, rtol=1e-5)


def _near_ties(q_jax, blocks):
    """Points whose JAX marginals leave the label to float32 rounding: the
    top two within 1e-5, or the maximum within 1e-5 of the 2/C floor."""
    out = []
    for q in np.split(q_jax, np.cumsum(blocks)[:-1]):
        top = np.sort(q, axis=0)[-2:]
        out.append((top[1] - top[0] < 1e-5) | (np.abs(top[1] - 2.0 / len(q)) < 1e-5))
    return out


@pytest.mark.parametrize("blocks", [(3, 4), (8, 9)])
def test_crf_labels_match_jax(lattice, blocks):
    built, norm = lattice
    u = _unaries(blocks, 1)
    unknown = tuple(c - 1 for c in blocks)
    want = jlm._crf_labels_multi(jnp.asarray(u), *built, jnp.float32(10.0),
                                 blocks, BUCKET, 10, unknown)
    got = tlm.crf_labels_multi(torch.from_numpy(u), _tensors(built), 10.0,
                               blocks, BUCKET, 10, unknown)
    q_jax = np.asarray(jax_mean_field(
        jnp.asarray(-u.T), *built, jnp.asarray(norm), jnp.float32(10.0),
        blocks, BUCKET, 10,
    ))
    for g, w, tie, unk in zip(got, want, _near_ties(q_jax, blocks), unknown):
        w = np.asarray(w)
        assert g.dtype == torch.int32
        assert tie.sum() <= 0.01 * N_POINTS
        np.testing.assert_array_equal(g.numpy()[~tie], w[~tie])
        assert (w != unk).any() and (w == unk).any()  # floor and argmax both hit

    poisoned = tlm.crf_labels_multi(torch.from_numpy(u), _tensors(built), 10.0,
                                    blocks, BUCKET, 10, unknown,
                                    overflow=torch.tensor(True))
    for lbl, unk in zip(poisoned, unknown):
        assert (lbl == unk).all()


# ----------------------------------------------------------------------
# LocalMapPipeline with the dense CRF on
# ----------------------------------------------------------------------


def _pipelines(proj_args, blocks, unknown, iterations, use_device_lattice=True):
    calibs, h, w = proj_args
    jp = jlm.LocalMapPipeline(
        JMultiProjector.from_calibrations(calibs, h, w, min_distance=0.5,
                                          max_distance=15.0),
        blocks, unknown,
        crf=jlm.CrfParams(use_dense_crf=True, iterations=iterations),
        use_device_lattice=use_device_lattice,
    )
    tp = tlm.LocalMapPipeline(
        MultiProjector.from_calibrations(calibs, h, w, min_distance=0.5,
                                         max_distance=15.0),
        blocks, unknown, "cpu",
        crf=tlm.CrfParams(use_dense_crf=True, iterations=iterations),
        use_device_lattice=use_device_lattice,
    )
    return jp, tp


def _nodes(posteriors, package):
    """One node per frame at the identity pose, posteriors as the package's
    arrays."""
    conv = jnp.asarray if package == "jax" else (lambda a: torch.tensor(a))
    cls = jlm.MapNodeFrames if package == "jax" else tlm.MapNodeFrames
    return [cls(pose=np.eye(4), posteriors=[[conv(p) for p in layers]])
            for layers in posteriors]


def test_crf_smoothing_path_matches_jax():
    """tests/test_fusion.py::test_crf_smoothing_path through both packages."""
    h, w = 20, 24
    calib = Calibration(
        intrinsic=np.array([[20.0, 0, w / 2], [0, 20.0, h / 2], [0, 0, 1]]),
        rotation=np.eye(3), translation=np.zeros(3),
    )
    rng = np.random.default_rng(0)
    n = 50
    pts = np.stack([rng.uniform(-0.4, 0.4, n), rng.uniform(-0.3, 0.3, n),
                    np.full(n, 2.0)], axis=1).astype(np.float32)
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    post = np.full((h, w, 3), 0.1, dtype=np.float32)
    post[..., 0] = 5.0
    jp, tp = _pipelines(([calib], h, w), [3], [2], 5)
    want = jp.run(pts, rgb, _nodes([[post]], "jax"))[0]
    got = tp.run(pts, rgb, _nodes([[post]], "torch"))[0]
    np.testing.assert_array_equal(got, want)
    _, idx = jp.projector.project(pts, np.eye(4))
    hit = np.unique(np.asarray(idx))
    hit = hit[hit >= 0]
    assert (got[hit] == 0).mean() > 0.9


@pytest.fixture(scope="module")
def worker():
    """The worker-path fixture of ``_dryrun_streaming_fused``: 32x40 frames
    through the JAX frame pipeline, two 70-point maps of two frames each."""
    rng = np.random.default_rng(2)
    h, w, n = 32, 40, 70
    calib = Calibration(
        intrinsic=np.array([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]]),
        rotation=np.eye(3), translation=np.zeros(3),
    )
    forest = random_forest(rng, num_trees=2, depth=6, num_features=366,
                           class_counts=[3, 4], max_nodes=101)
    fp = JSingleFramePipeline(
        JFeatureConfig(patch_size=15, patch_size_reduce=5), forest,
        stride=2, fill_value=0.0, use_pallas=True,
    )
    batch = 4
    rgbs = np.stack([rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                     for _ in range(batch)])
    depths = np.stack([rng.integers(600, 9000, (h, w)).astype(np.uint16)
                       for _ in range(batch)])
    kinv = np.tile(calib.intrinsic_inverse[None], (batch, 1, 1)).astype(np.float32)
    rot = np.tile(np.eye(3, dtype=np.float32)[None], (batch, 1, 1))
    results = fp.run_batch_stacked(rgbs, depths, kinv, rot,
                                   np.zeros((batch, 3), np.float32))
    posteriors = [[np.asarray(p) for p in r.posteriors] for r in results]
    pts = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.25, 0.25, n),
                    rng.uniform(1.5, 2.5, n)], axis=1).astype(np.float32)
    clouds = [pts + 0.01 * m for m in range(2)]
    crgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return ([calib], h, w), posteriors, clouds, crgb


@pytest.mark.parametrize("use_device_lattice", [True, False])
def test_worker_path_matches_jax(worker, use_device_lattice):
    proj_args, posteriors, clouds, crgb = worker
    jp, tp = _pipelines(proj_args, [3, 4], [2, 3], 3, use_device_lattice)
    known = []
    for m, cloud in enumerate(clouds):
        frames = posteriors[2 * m : 2 * m + 2]
        want = [np.asarray(l) for l in
                jp.run_device(cloud, crgb, _nodes(frames, "jax"))]
        got = tp.run_device(cloud, crgb, _nodes(frames, "torch"))
        for g, wl, unk in zip(got, want, (2, 3)):
            np.testing.assert_array_equal(g.numpy(), wl)
            known.append(int((wl != unk).sum()))
    assert max(known) > 0, known  # not every point fell to Unknown
    jp.flush()
    tp.flush()


def _host_reads(monkeypatch):
    """Record every tensor -> Python value conversion (each one waits for
    the device)."""
    reads = []
    for name in ("__int__", "__float__", "__bool__", "__index__", "item",
                 "tolist"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *args, _orig=orig, _name=name):
            reads.append(_name)
            return _orig(self, *args)

        monkeypatch.setattr(torch.Tensor, name, spy)
    return reads


def test_bucket_policy_matches_jax(worker, monkeypatch, caplog):
    proj_args, posteriors, clouds, crgb = worker
    jp, tp = _pipelines(proj_args, [3, 4], [2, 3], 3)
    cloud, n = clouds[0], clouds[0].shape[0]
    frames = posteriors[:2]

    def labels(pipe, package):
        out = pipe.run_device(cloud, crgb, _nodes(frames, package))
        return [np.asarray(l) for l in out]

    # The first map synchronises once and marks its size checked.
    first = labels(tp, "torch")
    assert n in tp._m_checked and tp._m_bucket == 1 << 14
    np.testing.assert_equal(first, labels(jp, "jax"))
    tp.flush()

    # A second map of that size runs without reading anything back.
    with monkeypatch.context() as patch:
        reads = _host_reads(patch)
        second = tp.run_device(cloud, crgb, _nodes(frames, "torch"))
        assert reads == []
    np.testing.assert_equal([l.numpy() for l in second], first)
    assert len(tp._pending_m) == 1

    # Forced overflow: a tiny bucket on a size marked checked. Both packages
    # label the whole map Unknown on the device.
    for pipe in (jp, tp):
        pipe.flush()
        pipe._m_bucket = 16
        pipe._m_checked.add(n)
    poisoned = labels(tp, "torch")
    np.testing.assert_equal(poisoned, labels(jp, "jax"))
    assert (poisoned[0] == 2).all() and (poisoned[1] == 3).all()

    with caplog.at_level(logging.WARNING):
        tp.flush()
    assert "lattice vertex bucket overflow" in caplog.text
    jp.flush()
    assert tp._m_bucket == jp._m_bucket > 16
    assert not tp._m_checked

    # The next map synchronises again and recovers.
    recovered = labels(tp, "torch")
    np.testing.assert_equal(recovered, first)
    np.testing.assert_equal(recovered, labels(jp, "jax"))
    tp.flush()
    jp.flush()


def test_missing_cloud_rgb_raises(worker):
    proj_args, posteriors, clouds, _ = worker
    _, tp = _pipelines(proj_args, [3, 4], [2, 3], 3)
    with pytest.raises(ValueError, match="dense CRF smoothing needs cloud RGB"):
        tp.run(clouds[0], None, _nodes(posteriors[:2], "torch"))
