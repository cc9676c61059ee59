"""The port's threefry2x32 emulation (``ops/prng.py``) against JAX's draws on
the CPU, bit for bit: ``jax.random.bits(jax.random.key(seed), shape,
uint32)`` over a few seeds and shapes, drawn whole and in chunks, and the
RANSAC draw ``jax.random.categorical`` over masked logits (0 on valid
entries, -inf elsewhere), drawn whole and a few rows at a time."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3d_slam_private_tpu_torch.ops import prng


@pytest.mark.parametrize("seed", [0, 42, 2 ** 32 - 1])
@pytest.mark.parametrize("shape", [(7,), (3, 5, 11), (4, 1000)])
def test_bits_equal_jax(seed, shape):
    want = np.asarray(jax.random.bits(jax.random.key(seed), shape, jnp.uint32)).astype(np.int64)
    assert np.array_equal(prng.bits(seed, shape).numpy(), want)
    assert np.array_equal(prng.bits(seed, shape, chunk=17).numpy(), want)


def test_bits_at_any_index_subset():
    """Counter mode: a word depends on its flat index alone."""
    want = np.asarray(jax.random.bits(jax.random.key(9), (64, 64), jnp.uint32)).astype(np.int64).reshape(-1)
    idx = torch.as_tensor(np.random.default_rng(0).choice(4096, 300, replace=False))
    assert np.array_equal(prng.bits_at(prng.key(9), idx).numpy(), want[idx.numpy()])


@pytest.mark.parametrize("seed,C,rows,share", [(0, 777, 50, 0.2), (3, 4096, 128, 0.5), (11, 300, 40, 0.02),
                                                (0, 2048, 64, 1.0)])
def test_masked_categorical_equals_jax(seed, C, rows, share):
    rng = np.random.default_rng(seed + C)
    mask = rng.uniform(size=C) < share
    mask[rng.integers(C)] = True
    logits = jnp.where(jnp.asarray(mask), 0.0, -jnp.inf)
    want = np.asarray(jax.random.categorical(jax.random.key(seed), logits[None], shape=(rows, 3)))
    m = torch.as_tensor(mask)
    assert np.array_equal(prng.masked_categorical(seed, m, rows, 3).numpy(), want)
    assert np.array_equal(prng.masked_categorical(seed, m, rows, 3, chunk_rows=7).numpy(), want)


def test_key_range():
    assert prng.key(5) == (0, 5)
    for bad in (-1, 2 ** 32):
        with pytest.raises(ValueError):
            prng.key(bad)
