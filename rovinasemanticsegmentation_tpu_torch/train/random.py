"""The random draws of the device tree growth: threefry-2x32 as JAX draws it.

The JAX trainer (``grow_tree_device``) draws each level's layer choice and
feature subsets with ``jax.random``: ``key = PRNGKey(seed)``, then per level
``k_lay, k_feat = split(fold_in(key, depth))``, ``randint(k_lay, (F,), 0,
L)`` and ``top_k(uniform(k_feat, (F, D)), k)``. This module draws the same
numbers, so the port grows the same trees.

It implements JAX's default, partitionable threefry (``jax_threefry_
partitionable``, on since JAX 0.5): the bits of element ``i`` of a draw of
any shape are ``b1 ^ b2`` of ``threefry2x32(key, (i >> 32, i & 0xffffffff))``
with ``i`` the row-major flat index. So ``uniform(k, (F, D))[s]`` does not
depend on ``F``, and a frontier of any size draws the same rows.

Keys are pairs of Python ints (two uint32 words) and are hashed on the host;
the bulk draws run as int64 tensor ops masked to 32 bits on the caller's
device.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

Key = Tuple[int, int]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(key: Key, x0, x1):
    """Threefry-2x32 with 20 rounds on uint32 words held in Python ints or
    int64 tensors; -> the two output words, like ``x0`` and ``x1``."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)  # ints, or tensors like x0
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & _M32
        x1 = (x1 + ks[(group + 2) % 3] + group + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: the words (0, seed)."""
    return 0, int(seed) & _M32


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in``: the hash of the count pair (0, data)."""
    return threefry2x32(key, 0, int(data) & _M32)


def split(key: Key, num: int = 2) -> List[Key]:
    """``jax.random.split`` (partitionable form): key ``i`` hashes (0, i)."""
    return [threefry2x32(key, 0, i) for i in range(num)]


def random_bits(key: Key, shape: Sequence[int], device) -> torch.Tensor:
    """32 random bits per element, as int64 in ``[0, 2**32)``."""
    return random_bits_many([(key, shape)], device)[0]


def random_bits_flat(draws: Sequence[Tuple[Key, Sequence[int]]],
                     device) -> torch.Tensor:
    """The bits of several (key, shape) draws, flattened one after another,
    in one evaluation of the hash (one set of ~140 elementwise launches
    instead of one per draw): each element carries its draw's key words and
    its flat index."""
    sizes = [math.prod(shape) for _, shape in draws]
    k0 = torch.cat([torch.full((n,), key[0], dtype=torch.int64, device=device)
                    for (key, _), n in zip(draws, sizes)])
    k1 = torch.cat([torch.full((n,), key[1], dtype=torch.int64, device=device)
                    for (key, _), n in zip(draws, sizes)])
    idx = torch.cat([torch.arange(n, dtype=torch.int64, device=device)
                     for n in sizes])
    b0, b1 = threefry2x32((k0, k1), idx >> 32, idx & _M32)
    return b0 ^ b1


def random_bits_many(draws: Sequence[Tuple[Key, Sequence[int]]],
                     device) -> List[torch.Tensor]:
    """:func:`random_bits` of several (key, shape) draws in one evaluation of
    the hash (:func:`random_bits_flat`)."""
    sizes = [math.prod(shape) for _, shape in draws]
    bits = random_bits_flat(draws, device).split(sizes)
    return [b.reshape(tuple(shape)) for b, (_, shape) in zip(bits, draws)]


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1): the top 23 bits as the mantissa of a float in
    [1, 2), minus 1 (JAX's ``_uniform``)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(key: Key, shape: Sequence[int], device) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``."""
    return uniform_from_bits(random_bits(key, shape, device))


def randint_from_bits(hi: torch.Tensor, lo: torch.Tensor, minval: int,
                      maxval: int) -> torch.Tensor:
    """64 random bits per value (``hi`` from the first key of the split,
    ``lo`` from the second) folded into the span in uint32 arithmetic, as
    JAX's ``_randint`` does."""
    span = maxval - minval if maxval > minval else 1
    mult = ((2**16 % span) ** 2 & _M32) % span  # the uint32 square wraps
    offset = (((hi % span) * mult) & _M32) + lo % span
    return (minval + (offset & _M32) % span).to(torch.int32)


def randint(
    key: Key, shape: Sequence[int], minval: int, maxval: int, device
) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)``."""
    k_hi, k_lo = split(key)
    hi, lo = random_bits_many([(k_hi, shape), (k_lo, shape)], device)
    return randint_from_bits(hi, lo, minval, maxval)


def top_k(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values, ties
    broken by the lower index (a stable descending sort; ``torch.topk``
    promises no tie order). -> (values, int64 indices)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
