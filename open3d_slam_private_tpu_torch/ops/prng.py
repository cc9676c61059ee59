"""The JAX package's random draws, bit for bit: threefry2x32 counter mode.

JAX's default generator is threefry2x32 with the partitionable layout: the
32-bit word at flat index ``i`` of ``jax.random.bits(key, shape, uint32)``
is ``hi ^ lo`` where ``(hi, lo) = threefry2x32(key, (i >> 32, i & M))``
(``jax/_src/prng.py`` ``_threefry_random_bits_partitionable``). Each word
depends on its index alone, so any subset of indices can be drawn, in any
chunks, to the same bits. uint32 arithmetic is emulated in int64 masked to
32 bits, as ``ops/grid_hash.py`` emulates the murmur hash.

``jax.random.categorical(key, logits[None], shape=(H, 3))`` is the argmax
over the last axis of ``gumbel(key, (H, 3, C)) + logits``, where the Gumbel
noise ``-log(-log(u))`` is increasing in ``u`` and ``u`` is increasing in the
top 23 bits of the word. With logits 0 on valid entries and -inf elsewhere
(the RANSAC draw) the sample is the first valid index at the maximum of
``bits >> 9``: integer work, with no dependence on how a device rounds
``log``.
"""

from __future__ import annotations

from typing import Tuple

import torch

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def key(seed: int) -> Tuple[int, int]:
    """``jax.random.key(seed)``'s two key words, ``(0, seed)``, for a seed in
    [0, 2^32) (JAX without 64-bit types takes the seed as a 32-bit int)."""
    seed = int(seed)
    if not 0 <= seed <= _M32:
        raise ValueError(f"seed {seed} outside [0, 2^32)")
    return 0, seed


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k: Tuple[int, int], x0: torch.Tensor, x1: torch.Tensor):
    """The threefry2x32 hash (20 rounds) of int64 counts in [0, 2^32),
    as ``jax/_src/prng.py`` ``_threefry2x32_lowering`` computes it."""
    ks = (k[0], k[1], k[0] ^ k[1] ^ _PARITY)
    x = [(x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _M32
    return x[0], x[1]


def bits_at(k: Tuple[int, int], index: torch.Tensor) -> torch.Tensor:
    """The words of ``jax.random.bits(key, shape, uint32)`` at int64 flat
    ``index`` (row-major in ``shape``), as int64 in [0, 2^32)."""
    index = index.to(torch.int64)
    hi, lo = threefry2x32(k, (index >> 32) & _M32, index & _M32)
    return hi ^ lo


def bits(seed: int, shape, device=None, chunk: int = 1 << 22) -> torch.Tensor:
    """``jax.random.bits(jax.random.key(seed), shape, jnp.uint32)`` as int64
    values, drawn ``chunk`` words at a time."""
    k = key(seed)
    n = 1
    for s in shape:
        n *= int(s)
    out = torch.empty(n, dtype=torch.int64, device=device)
    for a in range(0, n, chunk):
        idx = torch.arange(a, min(a + chunk, n), dtype=torch.int64, device=device)
        out[a:a + idx.shape[0]] = bits_at(k, idx)
    return out.reshape(tuple(int(s) for s in shape))


def masked_categorical(seed: int, mask: torch.Tensor, rows: int, draws: int,
                       chunk_rows: int = 64) -> torch.Tensor:
    """``jax.random.categorical(jax.random.key(seed), where(mask, 0, -inf)[None],
    shape=(rows, draws))`` for a ``[C]`` bool ``mask`` with a valid entry:
    ``[rows, draws]`` int64 indices into ``C``. Only the valid columns'
    words are drawn, ``chunk_rows`` rows at a time."""
    C = mask.shape[0]
    dev = mask.device
    cols = torch.nonzero(mask).reshape(-1)  # ascending
    n = cols.shape[0]
    k = key(seed)
    out = torch.empty((rows, draws), dtype=torch.int64, device=dev)
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    for a in range(0, rows, chunk_rows):
        r = torch.arange(a, min(a + chunk_rows, rows), dtype=torch.int64, device=dev)
        base = (r[:, None] * draws + torch.arange(draws, device=dev)[None, :]) * C  # [R, D]
        m = bits_at(k, base[..., None] + cols) >> 9  # [R, D, n]
        top = m.max(-1, keepdim=True).values
        first = torch.where(m == top, pos, n).min(-1).values
        out[a:a + r.shape[0]] = cols[first]
    return out
