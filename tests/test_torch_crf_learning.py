"""PyTorch port vs JAX reference: CRF learning on the CPU.

The same numpy inputs, made from seeds, go through the JAX package's
``models/crf_learning.py`` and ``models/lattice.py`` (differentiable parts)
and the port's counterparts. Tolerances, per contract:

- objectives: rtol 1e-5;
- ``differentiable_barycentric``: rtol 1e-6 against JAX (XLA fuses the
  elevation's multiply-adds), 1e-6 absolute against the build's own weights;
- ``lattice_filter_differentiable``: value rtol 1e-4 / atol 1e-5; feature
  gradient against ``jax.grad`` on the same host lattice rtol 1e-4 / atol
  1e-4 (measured: 5.7e-6 absolute on gradients up to 23, float32 splat sums
  in another order); the values' gradient bit-equal to the ``reverse=True``
  filter;
- ``mean_field_marginals``: rtol 2e-4 / atol 2e-5;
- learners' values rtol 1e-5 and gradients rtol 1e-3 / atol 1e-5 against
  JAX at the same parameters (float32 mean field through the filter's two
  summation orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rovinasemanticsegmentation_tpu.models import crf_learning as J
from rovinasemanticsegmentation_tpu.models import lattice as JL
from rovinasemanticsegmentation_tpu_torch.models import crf_learning as T
from rovinasemanticsegmentation_tpu_torch.models import lattice as TL

torch.set_num_threads(2)
CPU = "cpu"


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


class TestObjectives:
    def setup_method(self):
        rng = np.random.default_rng(0)
        self.q = rng.dirichlet(np.ones(4), size=50).astype(np.float32)
        self.gt = rng.integers(-1, 4, 50).astype(np.int32)

    @pytest.mark.parametrize("robust", [0.0, 0.1])
    def test_log_likelihood(self, robust):
        want = float(J.log_likelihood(jnp.asarray(self.q), jnp.asarray(self.gt), robust))
        got = float(T.log_likelihood(_t(self.q), _t(self.gt).long(), robust))
        assert got == pytest.approx(want, rel=1e-5)

    def test_hamming(self):
        w = T.hamming_class_weights(self.gt, 4, class_weight_pow=1.0)
        np.testing.assert_array_equal(w, J.hamming_class_weights(self.gt, 4, 1.0))
        want = float(J.hamming(jnp.asarray(self.q), jnp.asarray(self.gt), jnp.asarray(w)))
        got = float(T.hamming(_t(self.q), _t(self.gt).long(), _t(w)))
        assert got == pytest.approx(want, rel=1e-5)

    def test_intersection_over_union(self):
        want = float(J.intersection_over_union(jnp.asarray(self.q), jnp.asarray(self.gt)))
        got = float(T.intersection_over_union(_t(self.q), _t(self.gt).long()))
        assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("d", [2, 3, 5])
def test_differentiable_barycentric(d):
    rng = np.random.default_rng(10 + d)
    feats = rng.normal(0, 2, size=(300, d)).astype(np.float32)
    lattice = TL.build_lattice(feats, use_native=False)
    jl = JL.build_lattice(feats, use_native=False)
    np.testing.assert_array_equal(lattice.rem0, jl.rem0)
    np.testing.assert_array_equal(lattice.rank, jl.rank)
    want = np.asarray(JL.differentiable_barycentric(
        jnp.asarray(feats), jnp.asarray(jl.rem0), jnp.asarray(jl.rank)))
    got = TL.differentiable_barycentric(
        _t(feats), _t(lattice.rem0), _t(lattice.rank).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got, lattice.barycentric, rtol=0, atol=1e-6)


def test_geometry_keeps_rem0_and_rank_through_pad_and_stream():
    feats = np.random.default_rng(1).normal(size=(100, 3)).astype(np.float32)
    lattice = TL.build_lattice(feats, use_native=False)
    padded = TL.attach_sorted_stream(TL.pad_lattice(lattice, 1 << 10))
    assert padded.num_vertices == 1 << 10
    assert padded.rem0 is lattice.rem0 and padded.rank is lattice.rank
    geom = TL.lattice_geometry(padded, torch.device(CPU))
    np.testing.assert_array_equal(geom.rank.numpy(), lattice.rank)
    ones = torch.ones((100, 1))
    np.testing.assert_array_equal(
        TL.lattice_filter_diff(ones, None, geom)[:, 0].numpy(),
        TL.filter_ones_norm(lattice))


def test_device_geometry_equals_host_lattice():
    """The device build (here on the CPU) gives the NumPy build's rem0, rank
    and vertex topology, and the same filter, through a bucket overflow."""
    feats = np.random.default_rng(2).normal(0, 3, size=(400, 4)).astype(np.float32)
    lattice = TL.build_lattice(feats, use_native=False)
    geom = TL.lattice_geometry_device(_t(feats), m_bucket=64)
    assert geom.num_vertices >= lattice.num_vertices and geom.num_vertices % 64 == 0
    np.testing.assert_array_equal(geom.rem0.numpy(), lattice.rem0)
    np.testing.assert_array_equal(geom.rank.numpy(), lattice.rank)
    np.testing.assert_array_equal(geom.offsets_t.numpy().T, lattice.offsets)
    vals = _t(np.random.default_rng(3).normal(size=(400, 3)).astype(np.float32))
    host = TL.lattice_filter_diff(vals, None, TL.lattice_geometry(lattice, torch.device(CPU)))
    np.testing.assert_allclose(TL.lattice_filter_diff(vals, None, geom).numpy(),
                               host.numpy(), rtol=1e-5, atol=1e-6)


class TestDifferentiableFilter:
    def _problem(self, n=60, d=3, c=2, seed=0):
        rng = np.random.default_rng(seed)
        feats = rng.normal(size=(n, d)).astype(np.float32)
        a = rng.normal(size=(n, c)).astype(np.float32)
        b = rng.normal(size=(n, c)).astype(np.float32)
        return feats, a, b

    def test_value_matches_jax(self):
        feats, _, vals = self._problem(40, 4, 3, seed=1)
        lattice = JL.build_lattice(feats, use_native=False)
        want = np.asarray(JL.lattice_filter_differentiable(
            jnp.asarray(feats), jnp.asarray(vals), lattice))
        got = TL.lattice_filter_differentiable(
            _t(feats), _t(vals), TL.build_lattice(feats, use_native=False)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    def test_native_lattice_is_rebuilt_with_geometry(self):
        feats, _, vals = self._problem(40, 3, 2, seed=2)
        native = TL.build_lattice(feats)  # the C++ build keeps no rem0/rank
        got = TL.lattice_filter_differentiable(_t(feats), _t(vals), native)
        want = TL.lattice_filter_differentiable(
            _t(feats), _t(vals), TL.build_lattice(feats, use_native=False))
        assert torch.equal(got, want)

    @pytest.mark.parametrize("d", [2, 3, 5])
    def test_feature_and_value_gradients_match_jax(self, d):
        feats, a, b = self._problem(200, d, 2, seed=d)
        jl = JL.build_lattice(feats, use_native=False)

        def jobj(f, bb):
            return jnp.sum(jnp.asarray(a) * JL.lattice_filter_differentiable(f, bb, jl))

        gfj, gbj = jax.grad(jobj, argnums=(0, 1))(jnp.asarray(feats), jnp.asarray(b))
        f = _t(feats).requires_grad_(True)
        bt = _t(b).requires_grad_(True)
        out = TL.lattice_filter_differentiable(
            f, bt, TL.build_lattice(feats, use_native=False))
        (_t(a) * out).sum().backward()
        np.testing.assert_allclose(f.grad.numpy(), np.asarray(gfj), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gbj), rtol=1e-4, atol=1e-5)

    def test_value_gradient_is_the_reverse_filter(self):
        feats, a, b = self._problem(150, 3, 3, seed=4)
        lattice = TL.attach_sorted_stream(TL.build_lattice(feats, use_native=False))
        geom = TL.lattice_geometry(lattice, torch.device(CPU))
        bt = _t(b).requires_grad_(True)
        out = TL.lattice_filter_diff(bt, None, geom)
        tensors = TL.lattice_tensors(lattice, torch.device(CPU))
        assert torch.equal(out.detach(), TL.lattice_filter(_t(b), *tensors,
                                                           lattice.num_vertices))
        (_t(a) * out).sum().backward()
        rev = TL.lattice_filter(_t(a), *tensors, lattice.num_vertices, reverse=True)
        assert torch.equal(bt.grad, rev)

    def test_feature_gradient_matches_finite_differences(self):
        """tests/test_crf_learning.py:261 on the port (test_permutohedral.cpp
        methodology): the bulk of d/df a^T K b agrees with central
        differences; entries whose step crosses a simplex boundary may not."""
        feats, a, b = self._problem(24, 3, 2, seed=0)
        lattice = TL.build_lattice(feats, use_native=False)

        def objective(f):
            return (_t(a) * TL.lattice_filter_differentiable(f, _t(b), lattice)).sum()

        f = _t(feats).requires_grad_(True)
        objective(f).backward()
        num = T.numeric_gradient(
            lambda x: float(objective(_t(x.astype(np.float32)))),
            feats.astype(np.float64), eps=1e-3).reshape(feats.shape)
        close = np.isclose(f.grad.numpy(), num, rtol=5e-2, atol=5e-3)
        assert close.mean() > 0.9


def _potts_problem(seed, n=120, c=3):
    rng = np.random.default_rng(seed)
    unary = rng.normal(size=(n, c)).astype(np.float32)
    f1 = rng.normal(size=(n, 2)).astype(np.float32)
    f2 = rng.normal(0, 2, size=(n, 5)).astype(np.float32)
    gt = rng.integers(-1, c, n).astype(np.int32)
    return unary, (f1, f2), gt


def test_mean_field_marginals_match_jax():
    unary, feats, _ = _potts_problem(5)
    weights = [1.3, -0.7]
    want = np.asarray(J.mean_field_marginals(
        jnp.asarray(unary), [J.LearnablePotts.build(f) for f in feats],
        [jnp.float32(w) for w in weights], 5))
    got = T.mean_field_marginals(
        _t(unary), [T.LearnablePotts.build(f, device=CPU) for f in feats],
        weights, 5).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


class TestCrfLearner:
    def test_value_and_gradient_match_jax(self):
        """Logistic unary plus two Potts terms, 5 iterations, IoU objective."""
        rng = np.random.default_rng(6)
        n, c, nf = 150, 4, 4
        x = rng.normal(size=(n, nf)).astype(np.float32)
        l0 = (0.3 * rng.normal(size=(c, nf))).astype(np.float32)
        _, feats, gt = _potts_problem(7, n, c)
        jlearner = J.CrfLearner(
            J.LogisticUnaryEnergy(l0, x), [J.LearnablePotts.build(f) for f in feats],
            gt, n_iterations=5, objective=J.intersection_over_union)
        tlearner = T.CrfLearner(
            T.LogisticUnaryEnergy(l0, x, device=CPU),
            [T.LearnablePotts.build(f, device=CPU) for f in feats],
            gt, n_iterations=5, objective=T.intersection_over_union, device=CPU)
        params = tlearner.init_params([0.8, -0.4])
        vj, gj = jlearner._value_and_grad(jlearner.init_params([0.8, -0.4]))
        gj_flat = np.concatenate([np.asarray(gj["unary"]).ravel(),
                                  [float(g) for g in gj["weights"]]])
        vt, gt_flat = tlearner.objective_and_gradient(tlearner.flatten(params), params)
        assert vt == pytest.approx(float(vj), rel=1e-5)
        np.testing.assert_allclose(gt_flat, gj_flat, rtol=1e-3, atol=1e-5)
        # The same evaluation again gives the same bits.
        vt2, g2 = tlearner.objective_and_gradient(tlearner.flatten(params), params)
        assert vt2 == vt and np.array_equal(g2, gt_flat)

    def test_fit_improves_objective(self):
        """tests/test_crf_learning.py:112 on the port."""
        rng = np.random.default_rng(2)
        n, c = 100, 3
        feats = np.zeros((n, 2), np.float32)
        feats[n // 2:, 0] = 30.0
        gt = np.zeros(n, np.int32)
        gt[n // 2:] = 1
        unary = rng.normal(0, 1.0, size=(n, c)).astype(np.float32)
        unary[np.arange(n), gt] -= 1.0
        learner = T.CrfLearner(
            T.ConstUnaryEnergy(unary, device=CPU),
            [T.LearnablePotts.build(feats, device=CPU)], gt, n_iterations=5,
            device=CPU)
        params0 = learner.init_params([0.1])
        v0, _ = learner.objective_and_gradient(learner.flatten(params0), params0)
        params, best = learner.fit([0.1], max_iter=20)
        assert best >= -v0
        assert params["unary"] is None and len(params["weights"]) == 1

    def test_logistic_unary_learning(self):
        """tests/test_crf_learning.py:133 on the port."""
        rng = np.random.default_rng(3)
        n, c, f = 80, 3, 5
        x = rng.normal(size=(n, f)).astype(np.float32)
        true_l = rng.normal(size=(c, f)).astype(np.float32) * 2
        gt = np.argmax(x @ true_l.T, axis=1).astype(np.int32)
        feats = rng.normal(size=(n, 2)).astype(np.float32)
        unary = T.LogisticUnaryEnergy(np.zeros((c, f), np.float32), x, device=CPU)
        pot = T.LearnablePotts.build(feats, device=CPU)
        learner = T.CrfLearner(unary, [pot], gt, n_iterations=3, device=CPU)
        params, _ = learner.fit([0.0], max_iter=60)
        q = T.mean_field_marginals(unary.get(params["unary"]), [pot],
                                   params["weights"], 3)
        assert (q.argmax(1).numpy() == gt).mean() > 0.85


def _kernel_problem(seed, n, c, d):
    rng = np.random.default_rng(seed)
    unary = rng.normal(size=(n, c)).astype(np.float32)
    base = rng.normal(size=(n, d)).astype(np.float32)
    gt = rng.integers(0, c, n).astype(np.int32)
    return unary, base, gt


@pytest.mark.parametrize("kind,params", [
    ("Diag", np.array([1.1, 0.9])),
    ("Full", np.array([[1.1, 0.2], [-0.1, 0.9]])),
])
def test_kernel_learner_value_and_gradient_match_jax(kind, params):
    unary, base, gt = _kernel_problem(4, 60, 3, 2)
    extra = np.random.default_rng(8).normal(size=(60, 2)).astype(np.float32)
    jl = getattr(J, f"{kind}KernelCrfLearner")(
        unary, base, gt, n_iterations=2, extra_potentials=[J.LearnablePotts.build(extra)],
        extra_weights=[0.5])
    tl = getattr(T, f"{kind}KernelCrfLearner")(
        unary, base, gt, n_iterations=2,
        extra_potentials=[T.LearnablePotts.build(extra, device=CPU)],
        extra_weights=[0.5], device=CPU)
    vj, gwj, gpj = jl._neg_obj_and_grad(1.5, params)
    vt, gwt, gpt = tl._neg_obj_and_grad(1.5, params)
    assert vt == pytest.approx(vj, rel=1e-5)
    assert gwt == pytest.approx(gwj, rel=1e-3, abs=1e-5)
    assert gpt.shape == params.shape
    np.testing.assert_allclose(gpt, gpj, rtol=1e-3, atol=1e-5)


def test_diag_scale_gradient_matches_numeric():
    """tests/test_crf_learning.py:319 on the port."""
    unary, base, gt = _kernel_problem(4, 60, 3, 2)
    learner = T.DiagKernelCrfLearner(unary, base, gt, n_iterations=2, device=CPU)
    scales = np.array([1.1, 0.9])
    _, _, gs = learner._neg_obj_and_grad(1.5, scales)
    eps = 1e-3
    for k in range(2):
        sp, sm = scales.copy(), scales.copy()
        sp[k] += eps
        sm[k] -= eps
        num = (learner._neg_obj_and_grad(1.5, sp)[0]
               - learner._neg_obj_and_grad(1.5, sm)[0]) / (2 * eps)
        assert gs[k] == pytest.approx(num, rel=0.2, abs=2e-3)


def test_full_matrix_gradient_matches_numeric_on_a_fixed_lattice():
    """tests/test_crf_learning.py:371 on the port."""
    unary, base, gt = _kernel_problem(6, 50, 3, 2)
    learner = T.FullKernelCrfLearner(unary, base, gt, n_iterations=2, device=CPU)
    m = np.array([[1.1, 0.2], [-0.1, 0.9]])
    _, _, gm = learner._neg_obj_and_grad(1.5, m)
    eps = 1e-3
    for i in range(2):
        for j in range(2):
            mp, mm = m.copy(), m.copy()
            mp[i, j] += eps
            mm[i, j] -= eps
            num = (learner._neg_obj_and_grad(1.5, mp, lattice_at=m)[0]
                   - learner._neg_obj_and_grad(1.5, mm, lattice_at=m)[0]) / (2 * eps)
            assert gm[i, j] == pytest.approx(num, rel=5e-2, abs=1e-4)


def test_diag_fit_improves():
    """tests/test_crf_learning.py:348 on the port."""
    rng = np.random.default_rng(5)
    n, c = 80, 2
    base = np.zeros((n, 2), np.float32)
    base[n // 2:, 0] = 20.0
    base[:, 1] = rng.normal(size=n)
    gt = np.zeros(n, np.int32)
    gt[n // 2:] = 1
    unary = rng.normal(0, 1, size=(n, c)).astype(np.float32)
    unary[np.arange(n), gt] -= 0.8
    learner = T.DiagKernelCrfLearner(unary, base, gt, n_iterations=3, device=CPU)
    v0 = learner._neg_obj_and_grad(1.0, np.array([1.0, 1.0]))[0]
    _, scales, best = learner.fit(1.0, [1.0, 1.0], max_iter=15)
    assert best >= -v0 - 1e-6 and scales.shape == (2,)


def test_full_fit_finds_rotated_direction():
    """tests/test_crf_learning.py:400 on the port."""
    rng = np.random.default_rng(7)
    n, c = 80, 2
    sig = np.zeros(n, np.float32)
    sig[n // 2:] = 20.0
    noise = rng.normal(0, 6, size=n).astype(np.float32)
    base = np.stack([sig + noise, sig - noise], axis=1)
    gt = np.zeros(n, np.int32)
    gt[n // 2:] = 1
    unary = rng.normal(0, 1, size=(n, c)).astype(np.float32)
    unary[np.arange(n), gt] -= 0.8
    learner = T.FullKernelCrfLearner(unary, base, gt, n_iterations=3, device=CPU)
    v0 = learner._neg_obj_and_grad(1.0, np.eye(2))[0]
    _, mat, best = learner.fit(1.0, np.eye(2), max_iter=15)
    assert mat.shape == (2, 2) and best >= -v0 - 1e-6


def test_degenerate_parameters_give_a_huge_value_and_no_gradient():
    unary, base, gt = _kernel_problem(9, 30, 2, 2)
    learner = T.DiagKernelCrfLearner(unary, base, gt, device=CPU)
    v, gw, gp = learner._neg_obj_and_grad(1.0, np.array([1e9, 1.0]))
    assert v == 1e10 and gw == 0.0 and not gp.any()


def test_full_learner_rejects_non_square():
    learner = T.FullKernelCrfLearner(np.zeros((4, 2), np.float32),
                                     np.zeros((4, 2), np.float32),
                                     np.zeros(4, np.int32), device=CPU)
    with pytest.raises(ValueError):
        learner.fit(1.0, np.ones((2, 3)))


def test_numeric_gradient_matches_jax_package():
    def fn(x):
        return float(np.sum(np.sin(x) * x ** 2))

    x = np.random.default_rng(11).normal(size=(3, 2))
    np.testing.assert_array_equal(T.numeric_gradient(fn, x), J.numeric_gradient(fn, x))
