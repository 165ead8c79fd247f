"""The random draws of the reference's random forest, made on the host.

``repro.core.random_forest`` draws each tree's bootstrap weights and
feature mask from ``jax.random``.  This module is a NumPy copy of the parts
it uses, bit for bit, under JAX's default generator (``threefry2x32``) with
``jax_threefry_partitionable`` on, the default since JAX 0.5:

* ``threefry2x32``, the counter-based hash (20 rounds, 5 key injections);
* ``PRNGKey(seed)`` → the raw key (high and low 32 bits of the seed);
* ``split(key, num)``: hash of the counters 0 … num - 1 (high word 0);
* ``random_bits(key, shape)``: the two hash words of each flat index,
  xor-ed;
* ``uniform`` (float32: 23 random mantissa bits under exponent 0, minus
  1), ``randint`` (two words a value, reduced modulo the span) and
  ``poisson`` by Knuth's loop for λ < 10, whose ``log`` is the compiled
  float32 ``log`` of the reference's program (``features.xla_log``): the
  platform's ``log`` differs in the last bit on over 1 % of (0, 1], which
  flips a count whenever the running sum lands within an ulp of -λ.

Every function takes a key array of shape (..., 2) and maps over the
leading axes, as ``jax.vmap`` does: ``split`` returns (..., num, 2) and a
draw of ``shape`` returns (..., *shape).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.features import xla_log

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k1, k2, x1, x2) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash of the counter pair (x1, x2) under the key
    (k1, k2); all four broadcast together as uint32 arrays."""
    k1, k2, x1, x2 = np.broadcast_arrays(
        *(np.asarray(a, np.uint32) for a in (k1, k2, x1, x2)))
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(_PARITY))
    a, b = x1 + ks[0], x2 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = a + b
            b = a ^ _rotl(b, r)
        a = a + ks[(i + 1) % 3]
        b = b + ks[(i + 2) % 3] + np.uint32(i + 1)
    return a, b


def PRNGKey(seed: int) -> np.ndarray:
    """The raw (2,) uint32 key of an integer seed (a 32-bit seed, as JAX
    takes one without 64-bit mode: high word 0)."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} does not fit in 32 bits")
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def _hash_iota(key: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Both hash words of the counters 0 … n - 1 under every key of
    ``key`` (..., 2): each (..., n)."""
    key = np.asarray(key, np.uint32)
    lo = np.arange(n, dtype=np.uint32)
    return threefry2x32(key[..., 0:1], key[..., 1:2], np.zeros_like(lo), lo)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``num`` new keys from each key: (..., 2) → (..., num, 2)."""
    a, b = _hash_iota(key, num)
    return np.stack([a, b], axis=-1)


def random_bits(key: np.ndarray, shape: tuple = ()) -> np.ndarray:
    """32 random bits a value: (..., 2) keys → (..., *shape) uint32."""
    shape = tuple(shape)
    a, b = _hash_iota(key, math.prod(shape))
    return (a ^ b).reshape(np.shape(key)[:-1] + shape)


def uniform(key: np.ndarray, shape: tuple = ()) -> np.ndarray:
    """float32 values in [0, 1): (..., 2) keys → (..., *shape)."""
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def randint(key: np.ndarray, shape: tuple, minval: int, maxval: int
            ) -> np.ndarray:
    """int32 values in [minval, maxval): two 32-bit words a value, reduced
    modulo the span (``jax.random.randint``'s slight bias included)."""
    k = split(key)
    hi = random_bits(k[..., 0, :], shape)
    lo = random_bits(k[..., 1, :], shape)
    span = np.uint32(max(maxval - minval, 1))
    mult = np.uint32((2 ** 16 % int(span)) ** 2 % int(span))
    off = ((hi % span) * mult + lo % span) % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)


def poisson(key: np.ndarray, lam: float, shape: tuple) -> np.ndarray:
    """int32 Poisson(λ) counts by Knuth's loop, as ``jax.random.poisson``
    draws them for λ < 10: each round splits the key, draws one uniform a
    value and adds its log to the running sum; a value counts the rounds
    that start above -λ.  Keys of shape (..., 2) → (..., *shape); the loop
    runs until every value is done, as the batched loop does (a finished
    value takes no more counts)."""
    lam = np.float32(lam)
    if not 0 < lam < 10:
        raise ValueError(f"poisson draws 0 < lam < 10 by Knuth's loop, "
                         f"got {lam}")
    out_shape = (*np.shape(key)[:-1], *tuple(shape))
    k = np.zeros(out_shape, np.int32)
    log_prod = np.zeros(out_shape, np.float32)
    rng = np.asarray(key, np.uint32)
    while True:
        live = log_prod > -lam
        if not live.any():
            return k - 1
        keys = split(rng)
        rng, sub = keys[..., 0, :], keys[..., 1, :]
        k = np.where(live, k + 1, k).astype(np.int32)
        u = uniform(sub, shape)
        log_prod = log_prod + xla_log(torch.from_numpy(u)).numpy()
