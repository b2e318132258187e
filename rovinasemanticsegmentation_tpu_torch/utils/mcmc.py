"""Simulated annealing (libforest mcmc.h parity).

The port's copy of ``rovinasemanticsegmentation_tpu/utils/mcmc.py``, kept so
that the port imports nothing of the JAX package.

The reference vendors a generic simulated-annealing scaffold
(``third-party/libforest/src/mcmc.h``, unused by the ROVINA
pipeline itself but part of the library surface): a Metropolis loop over a
user-supplied move proposal and energy, with pluggable cooling schedules.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, TypeVar

import numpy as np

S = TypeVar("S")


@dataclass
class GeometricCooling:
    """T_{k+1} = alpha * T_k with a floor (mcmc.h's geometric schedule)."""

    start: float = 1.0
    alpha: float = 0.97
    minimum: float = 1e-3

    def __call__(self, step: int) -> float:
        return max(self.start * (self.alpha ** step), self.minimum)


def simulated_annealing(
    initial_state: S,
    energy: Callable[[S], float],
    propose: Callable[[S, np.random.Generator], S],
    num_steps: int = 1000,
    cooling: Callable[[int], float] = GeometricCooling(),
    seed: int = 0,
    callback: Optional[Callable[[int, S, float, float], None]] = None,
) -> Tuple[S, float]:
    """Metropolis annealing: accept worse states with prob exp(-dE/T).

    Returns the best (state, energy) seen.
    """
    rng = np.random.default_rng(seed)
    state = initial_state
    e = float(energy(state))
    best_state, best_e = state, e
    for step in range(num_steps):
        t = cooling(step)
        cand = propose(state, rng)
        ce = float(energy(cand))
        if ce <= e or rng.random() < math.exp(-(ce - e) / max(t, 1e-12)):
            state, e = cand, ce
            if e < best_e:
                best_state, best_e = state, e
        if callback is not None:
            callback(step, state, e, t)
    return best_state, best_e
