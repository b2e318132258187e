"""CRF parameter learning: objectives, logistic unary, L-BFGS-B fitting.

Counterpart of ``rovinasemanticsegmentation_tpu/models/crf_learning.py``,
after the densecrf learning stack (``objective.cpp:27-109``,
``unary.cpp:27-68``, ``optimization.cpp:27-135``). The mean-field iterations
are unrolled and differentiated with torch autograd; the lattice filter's
gradient is :class:`~.lattice._LatticeFilter`'s (the reverse-order filter for
the values, gathers for the barycentric weights), so no float atomics decide
a gradient and the card repeats it bit for bit. The lattice structure is
fixed per evaluation; the kernel learners rebuild it from the transformed
features at every evaluation (pairwise.cpp:140-151). scipy's ``L-BFGS-B``
drives every fit on the host, on float64 parameter vectors.

Objectives take marginals ``Q [N, C]`` and ground truth ``gt [N]`` (labels
< 0 ignored) and are maximised:

- :func:`log_likelihood`: mean log Q[gt] with a robustness epsilon
  (objective.cpp:37-50);
- :func:`hamming`: class-weighted expected accuracy (objective.cpp:51-80);
- :func:`intersection_over_union`: soft IoU over the marginals
  (objective.cpp:81-109).

Every class takes an explicit ``device``: ``"cpu"`` builds lattices on the
host, ``"cuda"`` on the card (:func:`~.lattice.lattice_geometry_device`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .crf import exp_and_normalize
from .lattice import (
    LatticeGeometry,
    build_lattice,
    differentiable_barycentric,
    lattice_filter_diff,
    lattice_geometry,
    lattice_geometry_device,
)

Objective = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


# ----------------------------------------------------------------------
# Objectives (maximised)
# ----------------------------------------------------------------------


def _pick(q: torch.Tensor, gt: torch.Tensor):
    """(labelled mask [N], one-hot of the clipped labels [N, C])."""
    c = q.shape[1]
    valid = (gt >= 0) & (gt < c)
    onehot = torch.clamp(gt, 0, c - 1)[:, None] == torch.arange(c, device=q.device)
    return valid, onehot


def log_likelihood(q: torch.Tensor, gt: torch.Tensor, robust: float = 0.0) -> torch.Tensor:
    """objective.cpp:37-50: mean over all points of log(Q[gt] + robust),
    unlabelled points adding 0. Q[gt] is a masked sum (a gather's backward
    would be an atomic scatter-add on the card)."""
    valid, onehot = _pick(q, gt)
    qq = torch.clamp(torch.where(onehot, q, 0.0).sum(dim=1) + robust, min=1e-20)
    return torch.where(valid, torch.log(qq), 0.0).sum() / q.shape[0]


def hamming_class_weights(gt: np.ndarray, num_classes: int, class_weight_pow: float) -> np.ndarray:
    """objective.cpp:51-64: w_c ∝ freq_c^-pow, normalised by sum cnt*w = 1."""
    cnt = np.bincount(gt[gt >= 0], minlength=num_classes).astype(np.float64)
    w = cnt / cnt.sum()
    with np.errstate(divide="ignore"):
        w = np.where(w > 0, w ** (-class_weight_pow), 0.0)
    return (w / (cnt * w).sum()).astype(np.float32)


def hamming(q: torch.Tensor, gt: torch.Tensor, class_weights: torch.Tensor) -> torch.Tensor:
    """objective.cpp:66-80: sum of w[gt] * Q[gt]."""
    valid, onehot = _pick(q, gt)
    qq = torch.where(onehot, q, 0.0).sum(dim=1)
    w = torch.as_tensor(class_weights, device=q.device)[torch.clamp(gt, 0, q.shape[1] - 1)]
    return torch.where(valid, w * qq, 0.0).sum()


def intersection_over_union(q: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """objective.cpp:81-109: mean over classes of soft I/U over marginals."""
    valid, onehot = _pick(q, gt)
    hot = (onehot & valid[:, None]).to(q.dtype)
    intersection = (hot * q).sum(dim=0)
    # Union: the class's labelled count plus Q of the class at points
    # labelled otherwise.
    union = 1e-20 + hot.sum(dim=0) + (q * valid[:, None] * (1.0 - hot)).sum(dim=0)
    return (intersection / union).sum() / q.shape[1]


# ----------------------------------------------------------------------
# Unary energies (unary.cpp:27-68)
# ----------------------------------------------------------------------


class ConstUnaryEnergy:
    def __init__(self, unary: np.ndarray, *, device: torch.device | str):  # [N, C]
        self.unary = torch.as_tensor(np.asarray(unary, np.float32),
                                     device=resolve_device(device))

    def get(self, params=None) -> torch.Tensor:
        return self.unary

    def init_params(self):
        return None


class LogisticUnaryEnergy:
    """U = f @ L^T with trainable L [C, F] over features f [N, F]
    (unary.cpp:45-68, points-major)."""

    def __init__(self, l_matrix: np.ndarray, f: np.ndarray, *,
                 device: torch.device | str):
        dev = resolve_device(device)
        self.features = torch.as_tensor(np.asarray(f, np.float32), device=dev)
        self._l0 = torch.as_tensor(np.asarray(l_matrix, np.float32), device=dev)

    def get(self, params: Optional[torch.Tensor] = None) -> torch.Tensor:
        l = self._l0 if params is None else params
        return self.features @ l.T  # [N, C]

    def init_params(self) -> torch.Tensor:
        return self._l0.clone()


# ----------------------------------------------------------------------
# Differentiable mean field + learners
# ----------------------------------------------------------------------


def geometry_for(features, device: torch.device, use_native: bool = True) -> LatticeGeometry:
    """The lattice of ``features`` [N, d] on ``device``: the host build on
    the CPU (``use_native=False`` keeps ``rem0`` and ``rank``), the device
    build with bucket escalation on the card."""
    if device.type == "cpu":
        feats = (features.detach().cpu().numpy() if isinstance(features, torch.Tensor)
                 else features)
        return lattice_geometry(build_lattice(feats, use_native=use_native), device)
    return lattice_geometry_device(torch.as_tensor(features, device=device))


class LearnablePotts:
    """One symmetric-normalised lattice-filtered Potts potential whose weight
    is learned; its lattice is fixed."""

    def __init__(self, geometry: LatticeGeometry, norm: torch.Tensor):
        self.geometry = geometry
        self.norm = norm  # [N], 1 / sqrt(filter of all-ones)

    @classmethod
    def build(cls, features: np.ndarray, *, device: torch.device | str) -> "LearnablePotts":
        dev = resolve_device(device)
        geom = geometry_for(np.asarray(features, np.float32), dev)
        ones = torch.ones((features.shape[0], 1), device=dev)
        raw = lattice_filter_diff(ones, None, geom)[:, 0]
        return cls(geom, 1.0 / torch.sqrt(raw + 1e-20))

    def filter(self, q: torch.Tensor) -> torch.Tensor:
        norm = self.norm[:, None]
        return lattice_filter_diff(q * norm, None, self.geometry) * norm


def mean_field_marginals(
    unary: torch.Tensor,  # [N, C] energy
    potentials: Sequence[LearnablePotts],
    weights: Sequence,  # Potts weight per potential (floats or 0-d tensors)
    n_iterations: int,
) -> torch.Tensor:
    """Unrolled, differentiable mean field (densecrf.cpp:115-131)."""
    q = exp_and_normalize(-unary)
    for _ in range(n_iterations):
        t = -unary
        for pot, w in zip(potentials, weights):
            t = t + w * pot.filter(q)  # Potts: compat = -w * filtered
        q = exp_and_normalize(t)
    return q


class CrfLearner:
    """Fit Potts weights (and a logistic unary's matrix, if it has one) to
    ground truth: autograd through the unrolled mean field, scipy's
    L-BFGS-B over the flattened parameters (densecrf.cpp:238-360,
    optimization.cpp:27-135)."""

    def __init__(
        self,
        unary_energy,
        potentials: Sequence[LearnablePotts],
        gt: np.ndarray,
        n_iterations: int = 5,
        objective: Objective = log_likelihood,
        *,
        device: torch.device | str,
    ):
        self.device = resolve_device(device)
        self.unary_energy = unary_energy
        self.potentials = list(potentials)
        self.gt = torch.as_tensor(gt.astype(np.int64), device=self.device)
        self.n_iterations = n_iterations
        self.objective = objective

    def init_params(self, initial_weights: Sequence[float]) -> Dict:
        return {
            "weights": [torch.tensor(float(w), device=self.device)
                        for w in initial_weights],
            "unary": self.unary_energy.init_params(),
        }

    def flatten(self, params: Dict) -> np.ndarray:
        """float64 vector: the unary matrix (if any), then the weights (the
        JAX package's ``ravel_pytree`` order)."""
        parts = [] if params["unary"] is None else [params["unary"].reshape(-1)]
        parts += [w.reshape(1) for w in params["weights"]]
        return torch.cat(parts).detach().cpu().double().numpy()

    def unflatten(self, x, like: Dict) -> Dict:
        """The flat parameters ``x`` (array or tensor) shaped like ``like``,
        as float32 tensors on the learner's device (views of a tensor)."""
        t = torch.as_tensor(np.asarray(x, np.float32) if isinstance(x, np.ndarray)
                            else x, device=self.device)
        out, k = {"unary": None}, 0
        if like["unary"] is not None:
            size = like["unary"].numel()
            out["unary"] = t[:size].reshape(like["unary"].shape)
            k = size
        out["weights"] = [t[k + i] for i in range(len(like["weights"]))]
        return out

    def _neg_objective(self, params: Dict) -> torch.Tensor:
        unary = self.unary_energy.get(params["unary"])
        q = mean_field_marginals(unary, self.potentials, params["weights"],
                                 self.n_iterations)
        return -self.objective(q, self.gt)

    def objective_and_gradient(self, x: np.ndarray, like: Dict) -> Tuple[float, np.ndarray]:
        """The negated objective and its float64 gradient at the flat
        parameters ``x`` (shaped like ``like``): what L-BFGS-B minimises."""
        leaves = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        leaves.requires_grad_(True)
        value = self._neg_objective(self.unflatten(leaves, like))
        (grad,) = torch.autograd.grad(value, [leaves])
        return float(value.detach()), grad.double().cpu().numpy()

    def fit(
        self, initial_weights: Sequence[float], max_iter: int = 50
    ) -> Tuple[Dict, float]:
        """L-BFGS-B over the flattened parameters; returns (params, objective)."""
        from scipy.optimize import minimize

        params0 = self.init_params(initial_weights)
        res = minimize(
            lambda x: self.objective_and_gradient(x, params0),
            self.flatten(params0), jac=True, method="L-BFGS-B",
            options={"maxiter": max_iter},
        )
        return self.unflatten(res.x, params0), -float(res.fun)


class _KernelCrfLearner:
    """Learn the feature transform of a Potts kernel (pairwise.cpp:116-163).

    The lattice is rebuilt from the transformed features at every
    evaluation; the gradient in the transform's parameters flows through the
    barycentric weights (:func:`~.lattice.differentiable_barycentric`)
    instead of the hand-derived ``featureGradient`` (:87-114). Subclasses
    give ``_transform(base, params)`` for DIAG (per-dimension scales,
    pairwise.cpp:208-230) and FULL (a dense d x d matrix, :232-254).
    """

    def __init__(
        self,
        unary: np.ndarray,  # [N, C] energies
        base_features: np.ndarray,  # [N, d] untransformed kernel features
        gt: np.ndarray,  # [N]
        n_iterations: int = 3,
        objective: Objective = log_likelihood,
        extra_potentials: Sequence[LearnablePotts] = (),
        extra_weights: Sequence[float] = (),
        *,
        device: torch.device | str,
    ):
        """``extra_potentials``/``extra_weights``: FIXED Potts terms in the
        mean field while the kernel's parameters are learned
        (dense_learning.cpp keeps the grid Gaussian in its kernel phase)."""
        self.device = resolve_device(device)
        self.unary = torch.as_tensor(np.asarray(unary, np.float32), device=self.device)
        self.base = torch.as_tensor(np.asarray(base_features, np.float32),
                                    device=self.device)
        self.gt = torch.as_tensor(gt.astype(np.int64), device=self.device)
        self.n_iterations = n_iterations
        self.objective = objective
        self.extra = list(zip(extra_potentials, [float(w) for w in extra_weights]))

    @staticmethod
    def _transform(base: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _neg_obj_and_grad(
        self, weight: float, params: np.ndarray, lattice_at: np.ndarray = None
    ) -> Tuple[float, float, np.ndarray]:
        """Value and gradients (weight, params) at ``params``, the lattice
        built at ``lattice_at`` (default ``params``): pass the unperturbed
        parameters to evaluate on a FIXED lattice, the analytic gradient's
        own semantics."""
        params = np.asarray(params, np.float32)
        at = params if lattice_at is None else np.asarray(lattice_at, np.float32)
        with torch.no_grad():
            feats = self._transform(self.base, torch.as_tensor(at, device=self.device))
            degenerate = bool(~torch.isfinite(feats).all() | (feats.abs().max() > 1e6))
        if degenerate:
            # A line search proposed degenerate kernel parameters: a huge
            # finite value makes L-BFGS-B backtrack (inf/nan would poison its
            # quasi-Newton state).
            return 1e10, 0.0, np.zeros(params.size, np.float64)
        geom = geometry_for(feats, self.device, use_native=False)

        w = torch.tensor(float(weight), device=self.device, requires_grad=True)
        p = torch.as_tensor(params, device=self.device).requires_grad_(True)
        bary = differentiable_barycentric(self._transform(self.base, p),
                                          geom.rem0, geom.rank)
        ones = torch.ones((self.base.shape[0], 1), device=self.device)
        norm = (1.0 / torch.sqrt(lattice_filter_diff(ones, bary, geom)[:, 0]
                                 + 1e-20))[:, None]  # symmetric normalisation
        q = exp_and_normalize(-self.unary)
        for _ in range(self.n_iterations):
            t = -self.unary + w * (lattice_filter_diff(q * norm, bary, geom) * norm)
            for pot, pw in self.extra:
                t = t + pw * pot.filter(q)
            q = exp_and_normalize(t)
        value = -self.objective(q, self.gt)
        gw, gp = torch.autograd.grad(value, [w, p])
        return float(value.detach()), float(gw), gp.double().cpu().numpy()

    def _fit_flat(
        self, initial_weight: float, params0: np.ndarray, max_iter: int
    ) -> Tuple[float, np.ndarray, float]:
        """L-BFGS-B over (weight, params); the lattice rebuilt per evaluation."""
        from scipy.optimize import minimize

        shape = params0.shape

        def fun(x):
            if not np.isfinite(x).all():
                return 1e10, np.zeros(x.size)
            v, gw, gp = self._neg_obj_and_grad(x[0], x[1:].reshape(shape))
            g = np.concatenate([[gw], gp.ravel()])
            if not (np.isfinite(v) and np.isfinite(g).all()):
                # Degenerate evaluation (collapsed lattice, saturated
                # softmax): a huge finite value so that L-BFGS-B backtracks.
                return 1e10, np.zeros(x.size)
            return v, g

        x0 = np.concatenate([[initial_weight], params0.ravel().astype(np.float64)])
        res = minimize(fun, x0, jac=True, method="L-BFGS-B",
                       options={"maxiter": max_iter})
        return float(res.x[0]), res.x[1:].reshape(shape).copy(), -float(res.fun)


class DiagKernelCrfLearner(_KernelCrfLearner):
    """DIAG_KERNEL: per-dimension feature scales (pairwise.cpp:208-230)."""

    @staticmethod
    def _transform(base: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
        return base * params[None, :]

    def fit(
        self, initial_weight: float, initial_scales: Sequence[float], max_iter: int = 30
    ) -> Tuple[float, np.ndarray, float]:
        return self._fit_flat(
            initial_weight, np.asarray(initial_scales, np.float64), max_iter)


class FullKernelCrfLearner(_KernelCrfLearner):
    """FULL_KERNEL: features' = A @ features with every entry of the d x d
    matrix A learned (pairwise.cpp:232-254)."""

    @staticmethod
    def _transform(base: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
        return base @ params.T

    def fit(
        self, initial_weight: float, initial_matrix: np.ndarray, max_iter: int = 30
    ) -> Tuple[float, np.ndarray, float]:
        m0 = np.asarray(initial_matrix, np.float64)
        if m0.ndim != 2 or m0.shape[0] != m0.shape[1]:
            raise ValueError("initial_matrix must be square [d, d]")
        return self._fit_flat(initial_weight, m0, max_iter)


def numeric_gradient(
    fn: Callable[[np.ndarray], float], x: np.ndarray, eps: float = 1e-3
) -> np.ndarray:
    """Central finite differences (optimization.cpp's numeric gradient)."""
    x = np.asarray(x, np.float64)
    g = np.zeros_like(x)
    for i in range(x.size):
        xp, xm = x.copy(), x.copy()
        xp.flat[i] += eps
        xm.flat[i] -= eps
        g.flat[i] = (fn(xp) - fn(xm)) / (2 * eps)
    return g
