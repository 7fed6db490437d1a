"""Counter-based Threefry-2x32 random numbers, bit for bit as ``jax.random``
draws them with its default ``threefry2x32`` keys.

A key is a pair of uint32 words ``(k1, k2)``.  Each word is held in int64
in [0, 2**32), masked with ``0xFFFFFFFF`` (Threefry only adds, rotates
and xors, so no int64 value ever overflows), either as a numpy array (the
host: a batch of row keys is a few values, and deriving them there costs
no device launch) or as a torch tensor on any device.  A batch of keys is
a pair of arrays of one shape, and every function works on the whole
batch at once.

- ``prng_key(seed)``: ``jax.random.PRNGKey`` of a 32-bit seed;
- ``fold_in(key, data)``: ``jax.random.fold_in``;
- ``random_bits(key, n)``: ``jax.random.bits(key, (n,), uint32)`` in the
  counter layout of ``jax_threefry_partitionable`` (the default since jax
  0.5): element i hashes the 64-bit counter (0, i) and xors the two
  output words;
- ``uniform(key, n, minval)``: ``jax.random.uniform(key, (n,),
  float32, minval, 1.0)``;
- ``gumbel(key, n)``: ``jax.random.gumbel(key, (n,), float32)`` in its
  default ``"low"`` mode, ``-log(-log(uniform(tiny, 1)))``.

``uniform`` and ``gumbel`` take torch keys.  The sources followed are
``jax/_src/prng.py`` (``threefry2x32``'s unrolled lowering,
``threefry_seed``, ``_threefry_fold_in``,
``_threefry_random_bits_partitionable``) and ``jax/_src/random.py``
(``_uniform``, ``_gumbel``).  The bits and the uniforms are bitwise
jax's; the Gumbel field goes through ``torch.log``, within a few ulp of
XLA's.
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Words = Union[np.ndarray, torch.Tensor]
Key = Tuple[Words, Words]


def _words(x, like) -> Words:
    """``x`` as int64 words in [0, 2**32) on the backend of ``like``."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(x, dtype=torch.int64,
                               device=like.device) & _MASK
    return np.asarray(x, dtype=np.int64) & _MASK


def threefry2x32(k1: Words, k2: Words, x1: Words,
                 x2: Words) -> Tuple[Words, Words]:
    """The Threefry-2x32 block function (20 rounds) of key (k1, k2) on the
    counter words (x1, x2); all four broadcast together.  x1 keeps the
    bits its adds carry past bit 31 until the end (they never reach the
    low word: adds carry upward, and x2 takes only x1's low 32 bits)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = x1 + ks[0]
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = x1 + x2
            x2 = (((x2 << r) | (x2 >> (32 - r))) ^ x1) & _MASK
        x1 = x1 + ks[(i + 1) % 3]
        x2 = (x2 + (ks[(i + 2) % 3] + (i + 1))) & _MASK
    return x1 & _MASK, x2


def prng_key(seed: int, device=None) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed in the int32 range: the
    high word 0, the low word the seed's 32 bits.  Numpy words, or torch
    tensors on ``device``."""
    words = np.array([0, int(seed) & _MASK], dtype=np.int64)
    if device is not None:
        words = torch.from_numpy(words).to(device)
    return words[0], words[1]


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in(key, data)``: the key hashes the counter
    (0, data mod 2**32).  ``data`` is an int or an array broadcasting with
    the key words (one value a key of a batch)."""
    k1, k2 = key
    d = _words(data, k1)
    return threefry2x32(k1, k2, d * 0, d)


def random_bits(key: Key, n: int) -> Words:
    """``jax.random.bits(key, (n,), uint32)`` as int64 in [0, 2**32).
    For a batch of keys of shape S the result is (*S, n)."""
    k1, k2 = key
    if isinstance(k1, torch.Tensor):
        lo = torch.arange(n, dtype=torch.int64, device=k1.device)
    else:
        lo = np.arange(n, dtype=np.int64)
    b1, b2 = threefry2x32(k1[..., None], k2[..., None], lo * 0, lo)
    return b1 ^ b2


def uniform(key: Key, n: int, minval: float = 0.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, 1.0)``: the top 23
    bits as the mantissa of a float in [1, 2), minus 1, scaled into
    [minval, 1) and clamped below at minval."""
    bits = random_bits(key, n)
    one = (bits >> 9) | 0x3F800000
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=bits.device)
    span = torch.tensor(1.0, dtype=torch.float32, device=bits.device) - lo
    return torch.maximum(lo, floats * span + lo)


def gumbel(key: Key, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` (mode "low")."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform(key, n, minval=tiny)))
