"""PyTorch port vs JAX: the device tree growth's random draws.

``train/random.py`` reproduces ``jax.random``'s partitionable threefry bit
for bit: keys, ``fold_in``, ``split``, ``randint``, ``uniform``, and
``jax.lax.top_k``'s lower-index tie rule, over many seeds, depths and shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rovinasemanticsegmentation_tpu_torch.train import random as tr

SEEDS = [0, 1, 7, 12345, 2**31 - 1, 2**31, 2**32 - 1, 3735928559]


def _key(k):
    return tuple(int(v) for v in np.asarray(k))


def test_jax_under_test_draws_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split(seed):
    key = jax.random.PRNGKey(jnp.uint32(seed))
    assert tr.prng_key(seed) == _key(key)
    for depth in (0, 1, 2, 5, 17, 30, 1000):
        folded = jax.random.fold_in(key, jnp.int32(depth))
        assert tr.fold_in(tr.prng_key(seed), depth) == _key(folded)
        for num in (2, 3):
            want = [_key(k) for k in jax.random.split(folded, num)]
            assert tr.split(_key(folded), num) == want


@pytest.mark.parametrize("seed", SEEDS[:5])
@pytest.mark.parametrize("shape", [(1,), (7,), (64,), (3, 5), (33, 366)])
def test_uniform_bits_equal(seed, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(jnp.uint32(seed)), 3)
    want = np.asarray(jax.random.uniform(key, shape))
    got = tr.uniform(_key(key), shape, "cpu").numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num_layers", [1, 2, 3])
def test_randint_equal(seed, num_layers):
    for depth in (0, 4, 29):
        key, _ = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(jnp.uint32(seed)), depth))
        for n in (1, 5, 200):
            want = np.asarray(jax.random.randint(key, (n,), 0, num_layers,
                                                 dtype=jnp.int32))
            got = tr.randint(_key(key), (n,), 0, num_layers, "cpu")
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)


def test_randint_wide_spans_and_offsets():
    key = jax.random.PRNGKey(5)
    for lo, hi in ((0, 7), (3, 1000), (-5, 70000), (0, 2**31 - 1), (4, 4)):
        want = np.asarray(jax.random.randint(key, (300,), lo, hi,
                                             dtype=jnp.int32))
        np.testing.assert_array_equal(
            tr.randint(_key(key), (300,), lo, hi, "cpu").numpy(), want)


def test_uniform_prefix_stable_in_the_frontier():
    """Row s of a draw of any frontier size is the same: the port draws
    at the live frontier size, JAX at its bucket."""
    key = tr.prng_key(99)
    big = tr.uniform(key, (256, 366), "cpu")
    np.testing.assert_array_equal(tr.uniform(key, (64, 366), "cpu").numpy(),
                                  big[:64].numpy())


@pytest.mark.parametrize("k", [1, 3, 8])
def test_top_k_ties_break_by_lower_index(k):
    vals = np.array([[0.5, 0.7, 0.5, 0.7, 0.1, 0.7, 0.5, 0.0],
                     [0.0] * 8,
                     [0.3, 0.3, 0.9, 0.3, 0.9, 0.1, 0.3, 0.9]], np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(vals), k)
    gv, gi = tr.top_k(torch.from_numpy(vals), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_top_k_of_uniform_draws_equal():
    """The feature subsets of a whole level, as both trainers draw them."""
    for seed in (0, 3, 11):
        key = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(jnp.uint32(seed)), 2))[1]
        _, want = jax.lax.top_k(jax.random.uniform(key, (40, 366)), 20)
        _, got = tr.top_k(tr.uniform(_key(key), (40, 366), "cpu"), 20)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_batched_draws_equal_separate_draws():
    """A level's three draws evaluated in one pass of the hash."""
    keys = tr.split(tr.fold_in(tr.prng_key(17), 4), 3)
    shapes = [(5,), (5,), (5, 366)]
    many = tr.random_bits_many(list(zip(keys, shapes)), "cpu")
    for got, key, shape in zip(many, keys, shapes):
        np.testing.assert_array_equal(got.numpy(),
                                      tr.random_bits(key, shape, "cpu").numpy())
    want = np.asarray(jax.random.uniform(jnp.asarray(np.array(keys[2], np.uint32)),
                                         (5, 366)))
    np.testing.assert_array_equal(tr.uniform_from_bits(many[2]).numpy(), want)
