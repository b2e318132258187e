"""Tree-by-tree comparison of two forests trained on the same data with the
same configuration, under the near-tie rule.

Two trainers that draw the same random numbers grow the same trees, except
where two candidate splits of a node have objectives so close that float32
rounding orders them differently (a ``log2`` that is not correctly rounded,
or another summation order). :func:`near_tie` takes a tree's first differing
node, recomputes in float64 the objectives of both forests' splits there on
the examples that reach it, and accepts the difference when they are within
``ULPS`` float32 ulp of the node's mass term ``m log2 m``, the largest term
of the float32 sum that decides the split.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from . import random as jrandom

ULPS = 8


def first_difference(fa, fb, t: int) -> Optional[int]:
    """First node id where tree ``t`` of the two forests differs, or None."""
    na, nb = fa.node_counts[t], fb.node_counts[t]
    n = min(na, nb)
    hits = np.nonzero(differing_nodes(fa, fb, t))[0]
    if len(hits):
        return int(hits[0])
    return None if na == nb else n


def differing_nodes(fa, fb, t: int) -> np.ndarray:
    """Mask of the nodes (of the shorter tree) whose split differs."""
    n = min(fa.node_counts[t], fb.node_counts[t])
    return ((fa.split_feature[t, :n] != fb.split_feature[t, :n])
            | (fa.threshold[t, :n] != fb.threshold[t, :n])
            | (fa.left_child[t, :n] != fb.left_child[t, :n]))


def _node_depths(left_child: np.ndarray) -> np.ndarray:
    depth = np.zeros(len(left_child), np.int64)
    for v, l in enumerate(left_child):
        if l:
            depth[l] = depth[l + 1] = depth[v] + 1
    return depth


def _reaching(x, sf, th, lc, v: int) -> np.ndarray:
    """Mask of the rows of ``x`` that reach node ``v``."""
    node = np.zeros(len(x), np.int64)
    while True:
        inner = (lc[node] != 0) & (node < v)
        if not inner.any():
            return node == v
        xv = x[np.arange(len(x)), sf[node]]
        node = np.where(inner, lc[node] + (xv >= th[node]), node)


def _node_layer(cfg, t: int, num_layers: int, d: int, depth, v: int,
                n: int) -> int:
    """The label layer the trainers drew for node ``v`` of tree ``t``."""
    if num_layers == 1:
        return 0
    level = int(depth[v])
    base = int(np.nonzero(depth == level)[0][0])
    rng = np.random.default_rng((cfg.seed, t))
    if cfg.use_bootstrap:
        rng.integers(0, n, size=cfg.num_bootstrap_examples or n)
    if not cfg.device_growth:
        for lev in range(level + 1):
            f = int((depth == lev).sum())
            layers = rng.integers(0, num_layers, size=f)
            for _ in range(f):
                rng.permutation(d)
        return int(layers[v - base])
    seed = int(np.uint32(rng.integers(0, 2**32, dtype=np.uint64)))
    k_lay, _ = jrandom.split(jrandom.fold_in(jrandom.prng_key(seed), level))
    f = int((depth == level).sum())
    return int(jrandom.randint(k_lay, (f,), 0, num_layers, "cpu")[v - base])


def _objective(x, cls, weights, f: int, thr: float) -> float:
    def ent(h):
        m = float(h.sum())
        out = m * math.log2(m) if m > 0 else 0.0
        return out - sum(c * math.log2(c) for c in h if c > 0)

    left = x[:, f] < thr
    c = len(weights)
    return (ent(np.bincount(cls[left], minlength=c) * weights)
            + ent(np.bincount(cls[~left], minlength=c) * weights))


def near_tie(fa, fb, t: int, v: int, x: np.ndarray, y: np.ndarray,
             cfg) -> Tuple[bool, str]:
    """Whether node ``v`` of tree ``t`` differs only by a near-tie; ``x``,
    ``y`` and ``cfg`` are what both forests were trained on."""
    y = y[:, None] if y.ndim == 1 else y
    n, d = x.shape
    lc = fa.left_child[t, : fa.node_counts[t]]
    if v >= fb.node_counts[t] or v >= len(lc):
        return False, f"tree {t}: node {v} exists in one forest only"
    if (lc[v] == 0) != (fb.left_child[t, v] == 0):
        return False, f"tree {t}: node {v} splits in one forest only"
    rng = np.random.default_rng((cfg.seed, t))
    idx = (rng.integers(0, n, size=cfg.num_bootstrap_examples or n)
           if cfg.use_bootstrap else np.arange(n))
    xs, ys = x[idx], y[idx]
    sf, th = fa.split_feature[t], fa.threshold[t]
    at = _reaching(xs, sf, th, lc, v)
    layer = _node_layer(cfg, t, y.shape[1], d, _node_depths(lc), v, n)
    cls = ys[at, layer].astype(np.int64)
    c = int(y[:, layer].max()) + 1
    weights = np.ones(c)
    if cfg.use_class_frequency and y.shape[1] == 1:
        counts = np.bincount(ys[:, 0], minlength=c).astype(np.float32)
        weights = np.where(counts > 0, len(ys) / np.maximum(counts, 1), 1.0)
    oa = _objective(xs[at], cls, weights, int(sf[v]), float(th[v]))
    ob = _objective(xs[at], cls, weights, int(fb.split_feature[t, v]),
                    float(fb.threshold[t, v]))
    m = float((np.bincount(cls, minlength=c) * weights).sum())
    ulp = float(np.spacing(np.float32(max(m * math.log2(max(m, 1.0)),
                                          abs(oa), abs(ob)))))
    return abs(oa - ob) <= ULPS * ulp, (
        f"tree {t} node {v} (layer {layer}, {int(at.sum())} examples): "
        f"split on {int(sf[v])} < {float(th[v])!r}, objective {oa!r}, against "
        f"{int(fb.split_feature[t, v])} < {float(fb.threshold[t, v])!r}, "
        f"{ob!r}: {abs(oa - ob) / ulp:.2f} float32 ulp apart")


def near_ties(fa, fb, x, y, cfg) -> List[str]:
    """Raise unless every tree is equal or differs from a near-tie at its
    first differing node on; -> the near-ties found."""
    if fa.num_trees != fb.num_trees:
        raise AssertionError(f"{fa.num_trees} trees against {fb.num_trees}")
    found = []
    for t in range(fa.num_trees):
        v = first_difference(fa, fb, t)
        if v is None:
            continue
        ok, what = near_tie(fa, fb, t, v, x, y, cfg)
        if not ok:
            raise AssertionError(f"not a near-tie: {what}")
        found.append(what)
    return found
