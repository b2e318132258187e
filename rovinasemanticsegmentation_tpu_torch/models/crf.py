"""Dense CRF with mean-field inference over point clouds and images.

Counterpart of ``rovinasemanticsegmentation_tpu/models/crf.py``, after the
Krähenbühl/Koltun engine (``densecrf.cpp``, ``pairwise.cpp``,
``labelcompatibility.cpp``):

- ``Q = expAndNormalize(-U - sum_k compat_k(kernel_k(Q)))`` per iteration
  (``densecrf.cpp:115-131``) with the max-subtracted softmax (``:98-106``);
- pairwise kernels are permutohedral lattice filters with NO / BEFORE /
  AFTER / SYMMETRIC normalisation (``pairwise.cpp:40-80``), SYMMETRIC by
  default;
- Potts (``-w Q``), diagonal (``diag(v) Q``) and symmetric matrix (``M Q``)
  label compatibilities (``labelcompatibility.cpp:44-108``);
- ``map`` is the per-point first-max argmax of the marginals
  (``densecrf.cpp:202-211``); ``kl_divergence`` the diagnostic of
  ``:214-235``.

:class:`DenseCRF`'s public tensors are points-major ``[N, C]``, as in the
JAX package. Its lattices are host builds (native builder first) carried
with their sorted splat stream, so every filter is
:func:`~.lattice.lattice_filter_t` and none uses float atomics.

The map path's fused mean field (:func:`potts_mean_field_multi_t`) runs
several independent Potts CRFs, one per label layer (``segmenter.cpp:638-644``),
through one filter per iteration in the transposed ``[C, N]`` layout, each
layer's softmax over its own block of channels. On CUDA tensors it and its
:func:`symmetric_norm` run in ``csrc/mean_field.cu``'s kernels (splat, blur
passes, slice fused with the update and softmax); the CPU, and tensors that
require grad, keep :func:`potts_mean_field_multi_plain_t`. :class:`DenseCRF`,
the 2D path and ``parallel/`` filter with ``lattice_filter_t`` everywhere.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..ops import mean_field_cuda
from .lattice import (
    PermutohedralLattice,
    attach_sorted_stream,
    build_lattice,
    lattice_filter,
    lattice_filter_t,
    lattice_tensors,
)


class NormalizationType(enum.Enum):
    NO_NORMALIZATION = 0
    NORMALIZE_BEFORE = 1
    NORMALIZE_AFTER = 2
    NORMALIZE_SYMMETRIC = 3


# ----------------------------------------------------------------------
# Label compatibilities
# ----------------------------------------------------------------------


class PottsCompatibility:
    """out = -w * Q (labelcompatibility.cpp:46-48)."""

    def __init__(self, weight: float):
        self.weight = float(weight)

    def apply(self, q: torch.Tensor) -> torch.Tensor:
        return -self.weight * q

    apply_transpose = apply


class DiagonalCompatibility:
    """out = diag(v) @ Q (labelcompatibility.cpp:66-69)."""

    def __init__(self, v: Sequence[float]):
        self.v = torch.from_numpy(np.asarray(v, dtype=np.float32))

    def apply(self, q: torch.Tensor) -> torch.Tensor:
        return q * self.v.to(q.device)[None, :]

    apply_transpose = apply


class MatrixCompatibility:
    """out = M @ Q with M symmetrised (labelcompatibility.cpp:79-87)."""

    def __init__(self, m: np.ndarray):
        m = np.asarray(m, dtype=np.float32)
        self.m = torch.from_numpy(0.5 * (m + m.T))

    def apply(self, q: torch.Tensor) -> torch.Tensor:
        return q @ self.m.to(q.device).T

    def apply_transpose(self, q: torch.Tensor) -> torch.Tensor:
        return q @ self.m.to(q.device)


Compatibility = Union[PottsCompatibility, DiagonalCompatibility, MatrixCompatibility]


# ----------------------------------------------------------------------
# Pairwise potential = normalisation o lattice filter o compatibility
# ----------------------------------------------------------------------


@dataclass
class PairwisePotential:
    lattice: PermutohedralLattice  # host build with its sorted stream
    compatibility: Compatibility
    ntype: NormalizationType
    tensors: Tuple[torch.Tensor, ...]  # lattice_tensors(lattice, device)
    _norm_cache: Optional[torch.Tensor] = None  # [N], already inverted

    @classmethod
    def build(
        cls,
        features: np.ndarray,  # [N, d]
        compatibility: Compatibility,
        ntype: NormalizationType = NormalizationType.NORMALIZE_SYMMETRIC,
        *,
        device: torch.device | str,
    ) -> "PairwisePotential":
        lattice = attach_sorted_stream(build_lattice(features))
        return cls(lattice, compatibility, ntype,
                   lattice_tensors(lattice, resolve_device(device)))

    @property
    def norm(self) -> torch.Tensor:
        if self._norm_cache is None:
            n = self.lattice.offsets.shape[0]
            ones = torch.ones((n, 1), device=self.tensors[0].device)
            raw = lattice_filter(ones, *self.tensors,
                                 self.lattice.num_vertices)[:, 0]
            self._norm_cache = _norm_from_raw_static(raw, self._pre_post())
        return self._norm_cache

    def _pre_post(self, transpose: bool = False) -> Tuple[bool, bool]:
        """Which side(s) of the filter the normalisation rides (pairwise.cpp:63-80)."""
        nt = self.ntype
        pre = (
            nt == NormalizationType.NORMALIZE_SYMMETRIC
            or (nt == NormalizationType.NORMALIZE_BEFORE and not transpose)
            or (nt == NormalizationType.NORMALIZE_AFTER and transpose)
        )
        post = (
            nt == NormalizationType.NORMALIZE_SYMMETRIC
            or (nt == NormalizationType.NORMALIZE_BEFORE and transpose)
            or (nt == NormalizationType.NORMALIZE_AFTER and not transpose)
        )
        return pre, post

    def _filter(self, q: torch.Tensor, transpose: bool) -> torch.Tensor:
        """pairwise.cpp:63-80."""
        pre, post = self._pre_post(transpose)
        out = q * self.norm[:, None] if pre else q
        out = lattice_filter(out, *self.tensors, self.lattice.num_vertices,
                             reverse=transpose)
        if post:
            out = out * self.norm[:, None]
        return out

    def apply(self, q: torch.Tensor) -> torch.Tensor:
        """Kernel, then compatibility (pairwise.cpp:173-178)."""
        return self.compatibility.apply(self._filter(q, transpose=False))

    def apply_transpose(self, q: torch.Tensor) -> torch.Tensor:
        return self.compatibility.apply_transpose(self._filter(q, transpose=True))


# ----------------------------------------------------------------------
# DenseCRF
# ----------------------------------------------------------------------


def _norm_from_raw_static(
    raw: torch.Tensor, flag_pair: Tuple[bool, bool]
) -> torch.Tensor:
    """Normalisation vector from the all-ones filter (pairwise.cpp:46-61).

    The (pre, post) flags at transpose=False identify the mode: both =
    SYMMETRIC, one = BEFORE/AFTER (the same inverse), none =
    NO_NORMALIZATION (the filter does not use the vector).
    """
    pre, post = flag_pair
    if pre and post:
        return 1.0 / torch.sqrt(raw + 1e-20)
    if pre or post:
        return 1.0 / (raw + 1e-20)
    return torch.full_like(raw, raw.shape[0]) / raw.sum()


def exp_and_normalize(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the labels with max subtraction (densecrf.cpp:98-106), [N, C]."""
    e = torch.exp(x - x.amax(dim=1, keepdim=True))
    return e / e.sum(dim=1, keepdim=True)


def _fused_potts_inference(
    unary: torch.Tensor,  # [N, C] energies, or [N] int labels (num_labels set)
    weights: Sequence[float],  # K Potts weights
    norms: Sequence[torch.Tensor],  # K x [N], or () to compute here
    latts: Sequence[Sequence[torch.Tensor]],  # K x the 8 lattice tensors
    n_iterations: int,
    flags: Sequence[Tuple[bool, bool]],  # K x (pre, post) normalisation
    ms: Sequence[int],  # K x num_vertices
    return_map: bool = False,
    num_labels: int = 0,
    label_energies: Optional[torch.Tensor] = None,  # [3] (u, n, p)
) -> torch.Tensor:
    """The mean-field loop of all-Potts potentials (densecrf.cpp:115-131).

    The op sequence per iteration is the step loop's, with the Potts
    compatibility folded in (``tmp - (-w out) = tmp + w out``). Options, as
    in the JAX package:

    - ``norms=()`` computes each potential's normalisation vector (filter
      of all-ones, pairwise.cpp:46-61) here;
    - ``num_labels=C`` with ``label_energies=(u, n, p)`` takes ``unary`` as
      an [N] label map and builds the [N, C] energies from it
      (dense_inference.cpp:37-52: unknown -> u everywhere; known -> n
      everywhere and p at the label);
    - ``return_map=True`` returns the first-max argmax (densecrf.cpp:202-211)
      as int32 labels instead of the marginals.
    """
    if num_labels:
        labels = unary.long()
        u_e, n_e, p_e = label_energies[0], label_energies[1], label_energies[2]
        base = torch.where(labels >= 0, n_e, u_e)[:, None]  # [N, 1]
        onehot = labels[:, None] == torch.arange(num_labels, device=unary.device)
        unary = torch.where(onehot, p_e, base)
    if not norms:
        ones = torch.ones((unary.shape[0], 1), device=unary.device)
        norms = [
            _norm_from_raw_static(lattice_filter(ones, *latt, m)[:, 0], flag)
            for latt, m, flag in zip(latts, ms, flags)
        ]
    q = exp_and_normalize(-unary)
    for _ in range(n_iterations):
        tmp = -unary
        for weight, norm, latt, m, (pre, post) in zip(weights, norms, latts,
                                                      ms, flags):
            out = q * norm[:, None] if pre else q
            out = lattice_filter(out, *latt, m)
            if post:
                out = out * norm[:, None]
            tmp = tmp + weight * out
        q = exp_and_normalize(tmp)
    if return_map:
        return torch.argmax(q, dim=1).to(torch.int32)
    return q


class DenseCRF:
    """Fully connected CRF over N variables with C labels on one device."""

    def __init__(self, n: int, num_labels: int, device: torch.device | str):
        self.n = int(n)
        self.num_labels = int(num_labels)
        self.device = resolve_device(device)
        self.unary: Optional[torch.Tensor] = None  # [N, C]
        self.pairwise: List[PairwisePotential] = []

    # -- energies ------------------------------------------------------
    def set_unary_energy(self, unary) -> None:
        """Constant unary energy [N, C] (unary.cpp ConstUnaryEnergy)."""
        unary = torch.as_tensor(unary, dtype=torch.float32, device=self.device)
        if tuple(unary.shape) != (self.n, self.num_labels):
            raise ValueError(f"unary energy of shape {tuple(unary.shape)}; "
                             f"the CRF has {self.n} x {self.num_labels}")
        self.unary = unary

    def add_pairwise_energy(
        self,
        features: np.ndarray,  # [N, d]
        compatibility: Compatibility,
        ntype: NormalizationType = NormalizationType.NORMALIZE_SYMMETRIC,
    ) -> None:
        if features.shape[0] != self.n:
            raise ValueError(f"{features.shape[0]} feature rows for "
                             f"{self.n} variables")
        self.pairwise.append(PairwisePotential.build(
            features, compatibility, ntype, device=self.device))

    def _unary_or_zeros(self) -> torch.Tensor:
        if self.unary is not None:
            return self.unary
        return torch.zeros((self.n, self.num_labels), device=self.device)

    # -- inference (densecrf.cpp:115-131) -------------------------------
    def start_inference(self) -> torch.Tensor:
        return exp_and_normalize(-self._unary_or_zeros())

    def step_inference(self, q: torch.Tensor) -> torch.Tensor:
        tmp1 = -self.unary if self.unary is not None else torch.zeros_like(q)
        for pw in self.pairwise:
            tmp1 = tmp1 - pw.apply(q)
        return exp_and_normalize(tmp1)

    def inference(self, n_iterations: int, fused: Optional[bool] = None) -> torch.Tensor:
        """Mean-field marginals [N, C] after ``n_iterations``.

        ``fused=None`` takes :func:`_fused_potts_inference` when every
        potential is Potts, and the step loop otherwise.
        """
        if fused is None:
            fused = self._can_fuse()
        if not fused:
            q = self.start_inference()
            for _ in range(n_iterations):
                q = self.step_inference(q)
            return q
        return self._fused(self._unary_or_zeros(), n_iterations)

    def _can_fuse(self) -> bool:
        return bool(self.pairwise) and all(
            isinstance(pw.compatibility, PottsCompatibility)
            for pw in self.pairwise
        )

    def _fused(self, unary: torch.Tensor, n_iterations: int, **kw) -> torch.Tensor:
        """:func:`_fused_potts_inference` over this CRF's potentials; with
        ``norms=()`` it computes the normalisation vectors itself."""
        pws = self.pairwise
        return _fused_potts_inference(
            unary, [pw.compatibility.weight for pw in pws], (),
            [pw.tensors for pw in pws], n_iterations,
            [pw._pre_post() for pw in pws],
            [pw.lattice.num_vertices for pw in pws], **kw,
        )

    def map_from_labels(
        self,
        labels: np.ndarray,  # [N] int, -1 = unknown
        energies: Tuple[float, float, float],  # (u, n, p) energies
        n_iterations: int,
    ) -> np.ndarray:
        """MAP labels with the unary built on the device from a label map
        (dense_inference.cpp:37-52 semantics; needs all-Potts potentials)."""
        if not self._can_fuse():
            raise ValueError("map_from_labels requires all-Potts potentials")
        dtype = np.int8 if self.num_labels < 128 else np.int32
        labels = torch.from_numpy(np.asarray(labels).astype(dtype))
        out = self._fused(
            labels.to(self.device), n_iterations,
            return_map=True, num_labels=self.num_labels,
            label_energies=torch.tensor(energies, dtype=torch.float32,
                                        device=self.device),
        )
        return out.cpu().numpy()

    def map(self, n_iterations: int) -> np.ndarray:
        """Per-point MAP labels (densecrf.cpp:132-137, 202-211)."""
        if self._can_fuse():
            out = self._fused(self._unary_or_zeros(), n_iterations,
                              return_map=True)
        else:
            out = torch.argmax(self.inference(n_iterations), dim=1)
        return out.to(torch.int32).cpu().numpy()

    # -- diagnostics -----------------------------------------------------
    def kl_divergence(self, q: torch.Tensor) -> float:
        """densecrf.cpp:214-235."""
        kl = torch.sum(q * torch.log(torch.clamp(q, min=1e-20)))
        if self.unary is not None:
            kl = kl + torch.sum(self.unary * q)
        for pw in self.pairwise:
            kl = kl + torch.sum(q * pw.apply(q))
        return float(kl)


class DenseCRF2D(DenseCRF):
    """Image CRF with grid Gaussian and bilateral feature builders."""

    def __init__(self, w: int, h: int, num_labels: int,
                 device: torch.device | str):
        super().__init__(w * h, num_labels, device)
        self.w = int(w)
        self.h = int(h)

    def add_pairwise_gaussian(
        self,
        sx: float,
        sy: float,
        compatibility: Compatibility,
        ntype: NormalizationType = NormalizationType.NORMALIZE_SYMMETRIC,
    ) -> None:
        """densecrf.cpp:61-69."""
        xs, ys = np.meshgrid(np.arange(self.w), np.arange(self.h))
        feats = np.stack([xs.ravel() / sx, ys.ravel() / sy], axis=1)
        self.add_pairwise_energy(feats.astype(np.float32), compatibility, ntype)

    def add_pairwise_bilateral(
        self,
        sx: float,
        sy: float,
        sr: float,
        sg: float,
        sb: float,
        rgb: np.ndarray,  # [H, W, 3] uint8
        compatibility: Compatibility,
        ntype: NormalizationType = NormalizationType.NORMALIZE_SYMMETRIC,
    ) -> None:
        """densecrf.cpp:70-81."""
        xs, ys = np.meshgrid(np.arange(self.w), np.arange(self.h))
        c = rgb.reshape(-1, 3).astype(np.float32)
        feats = np.stack(
            [xs.ravel() / sx, ys.ravel() / sy, c[:, 0] / sr, c[:, 1] / sg,
             c[:, 2] / sb],
            axis=1,
        )
        self.add_pairwise_energy(feats.astype(np.float32), compatibility, ntype)


# ----------------------------------------------------------------------
# Mean field of the map path (one Potts potential over
# [xyz * wxyz ; rgb * wrgb], segmenter.cpp:628-658)
# ----------------------------------------------------------------------


def normalize_blocks(x: torch.Tensor, blocks: Sequence[int]) -> torch.Tensor:
    """Max-subtracted softmax over each block of rows of ``x`` [C, N]."""
    parts = []
    for b in torch.split(x, list(blocks), dim=0):
        e = torch.exp(b - b.amax(dim=0, keepdim=True))
        parts.append(e / e.sum(dim=0, keepdim=True))
    return torch.cat(parts, dim=0)


def symmetric_norm(
    lattice: Sequence[torch.Tensor],  # the 8 tensors of build_lattice_device
    num_vertices: int,
) -> torch.Tensor:  # [N]
    """The symmetric normalisation ``1/sqrt(filter(ones))``
    (pairwise.cpp:54-56), on a CUDA lattice in ``csrc/mean_field.cu``'s
    kernels (``ops/mean_field_cuda.py``)."""
    barycentric_t = lattice[5]
    if mean_field_cuda.engages(None, barycentric_t):
        return mean_field_cuda.symmetric_norm(*lattice, num_vertices)
    ones = barycentric_t.new_ones((1, barycentric_t.shape[1]))
    raw = lattice_filter_t(ones, *lattice, num_vertices)[0]
    return 1.0 / torch.sqrt(raw + 1e-20)


def potts_mean_field_multi_t(
    unary_t: torch.Tensor,  # [sum(blocks), N] energies, layers stacked
    sorted_points: torch.Tensor,
    sorted_weights: torch.Tensor,
    seg_starts: torch.Tensor,
    seg_ends: torch.Tensor,
    offsets_t: torch.Tensor,
    barycentric_t: torch.Tensor,
    blur_n1: torch.Tensor,
    blur_n2: torch.Tensor,
    norm: torch.Tensor,  # [N] symmetric-normalisation vector
    weight: float,  # Potts weight
    blocks: Sequence[int],
    num_vertices: int,
    n_iterations: int,
) -> torch.Tensor:  # [sum(blocks), N] marginals
    """``n_iterations`` mean-field steps of the per-layer Potts CRFs
    (``Q = expAndNormalize(-U + w * norm * K(norm * Q))``). CUDA tensors
    take ``csrc/mean_field.cu``'s kernels (``ops/mean_field_cuda.py``), 1 +
    9 launches an iteration; the rest :func:`potts_mean_field_multi_plain_t`."""
    args = (unary_t, sorted_points, sorted_weights, seg_starts, seg_ends,
            offsets_t, barycentric_t, blur_n1, blur_n2, norm, weight, blocks,
            num_vertices, n_iterations)
    if mean_field_cuda.engages(unary_t, barycentric_t):
        return mean_field_cuda.potts_mean_field_multi_t(*args)
    return potts_mean_field_multi_plain_t(*args)


def potts_mean_field_multi_plain_t(
    unary_t: torch.Tensor,
    sorted_points: torch.Tensor,
    sorted_weights: torch.Tensor,
    seg_starts: torch.Tensor,
    seg_ends: torch.Tensor,
    offsets_t: torch.Tensor,
    barycentric_t: torch.Tensor,
    blur_n1: torch.Tensor,
    blur_n2: torch.Tensor,
    norm: torch.Tensor,
    weight: float,
    blocks: Sequence[int],
    num_vertices: int,
    n_iterations: int,
) -> torch.Tensor:
    """:func:`potts_mean_field_multi_t` in PyTorch ops on any device: one
    :func:`~.lattice.lattice_filter_t` and one :func:`normalize_blocks` an
    iteration."""
    q = normalize_blocks(-unary_t, blocks)
    for _ in range(n_iterations):
        filtered = lattice_filter_t(
            q * norm, sorted_points, sorted_weights, seg_starts, seg_ends,
            offsets_t, barycentric_t, blur_n1, blur_n2, num_vertices,
        ) * norm
        q = normalize_blocks(-unary_t + weight * filtered, blocks)
    return q


def potts_mean_field_multi(
    unary: torch.Tensor,  # [N, sum(blocks)] energies, layers side by side
    sorted_points: torch.Tensor,
    sorted_weights: torch.Tensor,
    seg_starts: torch.Tensor,
    seg_ends: torch.Tensor,
    offsets_t: torch.Tensor,
    barycentric_t: torch.Tensor,
    blur_n1: torch.Tensor,
    blur_n2: torch.Tensor,
    norm: torch.Tensor,  # [N]
    weight: float,
    blocks: Sequence[int],  # per-layer class counts
    num_vertices: int,
    n_iterations: int,
) -> torch.Tensor:  # [N, sum(blocks)]
    """Points-major face of :func:`potts_mean_field_multi_t`: several
    independent Potts CRFs sharing one lattice, each layer's softmax within
    its block."""
    return potts_mean_field_multi_t(
        unary.T, sorted_points, sorted_weights, seg_starts, seg_ends,
        offsets_t, barycentric_t, blur_n1, blur_n2, norm, weight, blocks,
        num_vertices, n_iterations,
    ).T


def potts_mean_field(
    unary: torch.Tensor,  # [N, C] (the CRF energy, i.e. -accumulated unaries)
    sorted_points: torch.Tensor,
    sorted_weights: torch.Tensor,
    seg_starts: torch.Tensor,
    seg_ends: torch.Tensor,
    offsets_t: torch.Tensor,
    barycentric_t: torch.Tensor,
    blur_n1: torch.Tensor,
    blur_n2: torch.Tensor,
    norm: torch.Tensor,  # [N]
    weight: float,
    num_vertices: int,
    n_iterations: int,
) -> torch.Tensor:  # [N, C]
    """Mean field with one symmetric-normalised Potts kernel: the one-layer
    case of :func:`potts_mean_field_multi`."""
    return potts_mean_field_multi(
        unary, sorted_points, sorted_weights, seg_starts, seg_ends, offsets_t,
        barycentric_t, blur_n1, blur_n2, norm, weight, (unary.shape[1],),
        num_vertices, n_iterations,
    )
