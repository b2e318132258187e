"""CRF parameter-learning demo (parity with densecrf's dense_learning example).

Usage: python -m rovinasemanticsegmentation_tpu_torch.cli.dense_learning \
           <image.ppm> <annotation.ppm> <output.ppm> [--scale=N] [--device cuda|cpu]

Counterpart of ``rovinasemanticsegmentation_tpu/cli/dense_learning.py``,
after ``examples/dense_learning.cpp``: M = 4 labels from the annotation's
first-appearance colours, a trainable logistic unary over ``[r, g, b, 1]``
colour features (initialised ``0.01 * (1 - 2u)`` from numpy's
``default_rng(seed)``), a grid Gaussian Potts term (sx = sy = 3) and an
appearance bilateral term (80, 80, 13, 13, 13), the IntersectionOverUnion
objective over 5 mean-field iterations, and the reference's three
optimisation phases (dense_learning.cpp:146-175):

1. the unary's parameters only;
2. the unary and both Potts weights;
3. the bilateral kernel's feature transform (a FULL d x d matrix,
   ``FullKernelCrfLearner``), the Gaussian term held fixed.

As in the JAX package: the reference's MatrixCompatibility(Identity) on the
bilateral term is a Potts weight of -1, and phase 3 learns the kernel with
phase 2's unary and weights frozen. ``--scale=N`` keeps every N-th pixel
(nearest neighbour, so annotation colours stay exact).
"""

from __future__ import annotations

import sys
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.crf_learning import (
    FullKernelCrfLearner,
    LearnablePotts,
    LogisticUnaryEnergy,
    intersection_over_union,
    mean_field_marginals,
)
from ..utils.imageio import load_ppm, save_ppm
from ..utils.profiling import StepTimer
from .dense_inference import colorize

M = 4  # dense_learning.cpp:92
NIT = 5  # dense_learning.cpp:143
# The bilateral kernel's feature scales 1 / (80, 80, 13, 13, 13).
BILATERAL_SCALE = np.array([1 / 80.0, 1 / 80.0, 1 / 13.0, 1 / 13.0, 1 / 13.0])


def labeling_from_annotation(anno: np.ndarray, max_labels: int) -> np.ndarray:
    """First-appearance colour -> label id, black -> -1 (common.cpp
    getLabeling); colours after the first ``max_labels`` are -1 too."""
    packed = (
        anno[..., 0].astype(np.int32)
        | (anno[..., 1].astype(np.int32) << 8)
        | (anno[..., 2].astype(np.int32) << 16)
    ).reshape(-1)
    uniq, first, inverse = np.unique(packed, return_index=True, return_inverse=True)
    ids = np.full(len(uniq), -1, np.int32)
    next_id = 0
    for u in np.argsort(first, kind="stable"):
        if uniq[u] != 0 and next_id < max_labels:
            ids[u] = next_id
            next_id += 1
    return ids[inverse.reshape(-1)]


def synthetic_pair(h: int, w: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """A learning demo input made from ``seed``, for runs without the
    densecrf example images: an RGB image of 12 noisy Voronoi regions, each
    of one of 4 classes with a colour of its own, and the annotation in the
    4 class colours with 20% of its pixels unknown (black)."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    seeds = rng.uniform([0, 0], [h, w], (12, 2))
    region = np.argmin((ys[..., None] - seeds[:, 0]) ** 2
                       + (xs[..., None] - seeds[:, 1]) ** 2, axis=-1)
    region_class = np.concatenate([np.arange(M), rng.integers(0, M, 12 - M)])
    colours = rng.integers(40, 216, (12, 3))
    im = colours[region] + rng.normal(0, 25, (h, w, 3))
    palette = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 255, 0]])
    anno = palette[region_class[region]]
    anno[rng.random((h, w)) < 0.2] = 0
    return np.clip(im, 0, 255).astype(np.uint8), anno.astype(np.uint8)


class DemoModel(NamedTuple):
    """The demo's CRF at its initial parameters."""

    unary: LogisticUnaryEnergy  # over [r, g, b, 1] / 255, L from the seed
    gauss: LearnablePotts  # (x, y) / 3
    bilateral: LearnablePotts  # bilateral_base * BILATERAL_SCALE
    gt: np.ndarray  # [N] int32, -1 unknown
    bilateral_base: np.ndarray  # [N, 5] float32 (x, y, r, g, b)


def demo_model(im: np.ndarray, anno: np.ndarray, seed: int,
               device: torch.device | str) -> DemoModel:
    """The model of dense_learning.cpp:92-133 for an [H, W, 3] image and its
    annotation: logistic colour features [r, g, b, 1] with L initialised
    ``0.01 * (1 - 2u)`` from ``default_rng(seed)``, and both Potts terms."""
    h, w = im.shape[:2]
    n = h * w
    feats_u = np.concatenate(
        [im.reshape(-1, 3).astype(np.float32) / 255.0, np.ones((n, 1), np.float32)],
        axis=1,
    )
    rng = np.random.default_rng(seed)
    l0 = (0.01 * (1.0 - 2.0 * rng.random((M, 4)))).astype(np.float32)
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    gauss_feats = np.stack([xs.ravel() / 3.0, ys.ravel() / 3.0], axis=1).astype(
        np.float32)
    c = im.reshape(-1, 3).astype(np.float32)
    bilateral_base = np.stack(
        [xs.ravel(), ys.ravel(), c[:, 0], c[:, 1], c[:, 2]], axis=1
    ).astype(np.float32)
    return DemoModel(
        LogisticUnaryEnergy(l0, feats_u, device=device),
        LearnablePotts.build(gauss_feats, device=device),
        LearnablePotts.build(
            (bilateral_base * BILATERAL_SCALE[None, :]).astype(np.float32),
            device=device),
        labeling_from_annotation(anno, M),
        bilateral_base,
    )


def run(
    image_path: str,
    anno_path: str,
    out_path: str,
    seed: int = 0,
    scale: int = 1,
    device: torch.device | str = "cuda",
    timer: Optional[StepTimer] = None,
) -> List[float]:
    """Learn the three phases, write the MAP labelling, return the IoU
    objective after each phase. ``timer`` (optional) gets a span per phase
    (``phase 1``..``phase 3``) and per objective-and-gradient evaluation of
    phases 1 and 2 (``evaluation``)."""
    dev = resolve_device(device)
    timer = timer if timer is not None else StepTimer()
    im = load_ppm(image_path)
    anno = load_ppm(anno_path)
    if scale > 1:
        im = im[::scale, ::scale]
        anno = anno[::scale, ::scale]
    h, w = im.shape[:2]
    model = demo_model(im, anno, seed, dev)
    unary_energy, gauss, bilateral = model.unary, model.gauss, model.bilateral
    gt, bilateral_base = model.gt, model.bilateral_base
    gt_t = torch.from_numpy(gt.astype(np.int64)).to(dev)

    def objective(l_params, weights):
        q = mean_field_marginals(unary_energy.get(l_params), [gauss, bilateral],
                                 weights, NIT)
        return intersection_over_union(q, gt_t)

    def value_and_grad(x: np.ndarray, split):
        """-objective and its float64 gradient at the flat float64 ``x``."""
        with timer.span("evaluation"):
            leaves = torch.as_tensor(x.astype(np.float32), device=dev)
            leaves.requires_grad_(True)
            value = -objective(*split(leaves))
            (grad,) = torch.autograd.grad(value, [leaves])
            return float(value.detach()), grad.double().cpu().numpy()

    def lbfgs(fun, x0, max_iter):
        from scipy.optimize import minimize

        return minimize(fun, x0, jac=True, method="L-BFGS-B",
                        options={"maxiter": max_iter}).x

    def evaluate(l_params, weights) -> float:
        with torch.no_grad():
            l = torch.as_tensor(np.asarray(l_params, np.float32), device=dev)
            return float(objective(l, [float(np.float32(v)) for v in weights]))

    # Identity MatrixCompatibility == Potts weight -1 (see module docstring).
    weights = [np.float32(1.0), np.float32(-1.0)]
    history = []

    # Phase 1: unary only (dense_learning.cpp learning_params row 1).
    fixed = [float(v) for v in weights]
    with timer.span("phase 1"):
        l_params = lbfgs(
            lambda x: value_and_grad(x, lambda t: (t.reshape(M, 4), fixed)),
            unary_energy.init_params().double().cpu().numpy().ravel(),
            12).reshape(M, 4)
        history.append(evaluate(l_params, weights))
    print(f"phase 1 (unary):            IoU objective = {history[-1]:.4f}")

    # Phase 2: unary + pairwise weights.
    with timer.span("phase 2"):
        x = lbfgs(
            lambda x: value_and_grad(x, lambda t: (t[:-2].reshape(M, 4), [t[-2], t[-1]])),
            np.concatenate([np.asarray(l_params, np.float64).ravel(), weights]), 12)
        l_params, weights = x[:-2].reshape(M, 4), [x[-2], x[-1]]
        history.append(evaluate(l_params, weights))
    print(f"phase 2 (unary + pairwise): IoU objective = {history[-1]:.4f}")

    # Phase 3: bilateral kernel transform (FULL d x d), Gaussian fixed.
    with timer.span("phase 3"):
        with torch.no_grad():
            unary_now = unary_energy.get(torch.as_tensor(
                l_params.astype(np.float32), device=dev)).cpu().numpy()
        learner = FullKernelCrfLearner(
            unary_now, bilateral_base, gt, n_iterations=NIT,
            objective=intersection_over_union, extra_potentials=[gauss],
            extra_weights=[weights[0]], device=dev,
        )
        kw, kmat, obj3 = learner.fit(
            float(weights[1]),  # the kernel term's Potts weight (t = -U + w K Q)
            np.diag(BILATERAL_SCALE), max_iter=6)
        history.append(obj3)
    print(f"phase 3 (full kernel):      IoU objective = {history[-1]:.4f}")
    print("unary parameters:", np.asarray(l_params).ravel())
    print("pairwise weights:", [float(v) for v in weights])
    print("kernel matrix diag:", np.diag(kmat))

    # MAP with the learned model (kernel transform applied to the features).
    bilateral_learned = LearnablePotts.build(
        (bilateral_base @ np.asarray(kmat, np.float32).T).astype(np.float32),
        device=dev)
    with torch.no_grad():
        q = mean_field_marginals(
            unary_energy.get(torch.as_tensor(l_params.astype(np.float32), device=dev)),
            [gauss, bilateral_learned], [float(np.float32(weights[0])),
                                         float(np.float32(kw))], NIT)
    labels = torch.argmax(q, dim=1).to(torch.int32).cpu().numpy()
    save_ppm(out_path, colorize(labels, anno).reshape(h, w, 3))
    return history


def main(argv=None) -> None:
    args = list(sys.argv[1:] if argv is None else argv)
    scale, device = 1, "cuda"
    rest = []
    it = iter(args)
    for a in it:
        if a.startswith("--scale="):
            scale = int(a.split("=", 1)[1])
        elif a == "--device":
            device = next(it, "")
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    if len(rest) != 3 or device not in ("cuda", "cpu"):
        print("Usage: dense_learning <image.ppm> <annotation.ppm> <output.ppm>"
              " [--scale=N] [--device cuda|cpu]")
        raise SystemExit(1)
    run(rest[0], rest[1], rest[2], scale=scale, device=device)


if __name__ == "__main__":
    main()
