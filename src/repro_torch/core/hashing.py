"""Stateless integer hashing for HashedNets (Chen et al., ICML 2015).

The same murmur3-finalizer hash as the JAX package's ``core/hashing.py``:
a connection key (i, j, seed) maps to a bucket h(i, j) and an independent
sign xi(i, j) in {-1, +1}.  PyTorch has no uint32 arithmetic on the CPU,
so every function here works on int64 tensors holding values in
[0, 2**32) and masks with ``0xFFFFFFFF`` after each multiply and add.
The products are split into 16-bit halves so no int64 product overflows.
The CUDA kernels (``kernels/csrc``) compute the same function in native
``uint32_t`` wrap-around arithmetic.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
# murmur3 / splitmix constants
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9
_J_OFFSET = 0x165667B1
SIGN_SEED_XOR = 0x5BF03635


def _u32(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    return x.to(torch.int64) & _MASK


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32) without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def mix32(x) -> torch.Tensor:
    """murmur3 finalizer: avalanche a uint32 (held in int64)."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    x = x ^ (x >> 16)
    return x


def hash_key(i, j, seed: int) -> torch.Tensor:
    """Combine (i, j, seed) -> well-mixed uint32 (as int64).

    i, j may be scalars or broadcastable integer tensors.  Two mixing
    rounds decorrelate rows and columns."""
    i = _u32(i)
    j = _u32(j)
    s = seed & _MASK
    h = mix32((_mul32(i, _GOLDEN) + s) & _MASK)
    return mix32(h ^ ((_mul32(j, _M1) + _J_OFFSET) & _MASK))


def bucket_hash(i, j, num_buckets: int, seed: int) -> torch.Tensor:
    """h(i,j) in {0..num_buckets-1} (paper Eq. 3).  The key is
    non-negative, so ``%`` is the unsigned remainder for any bucket
    count, power of two or not."""
    return hash_key(i, j, seed) % int(num_buckets)


def sign_hash(i, j, seed: int) -> torch.Tensor:
    """xi(i,j) in {-1,+1} (paper Eq. 7), from a derived seed so that h
    and xi are decorrelated; the top bit picks the sign."""
    h = hash_key(i, j, seed ^ SIGN_SEED_XOR)
    return 1 - 2 * (h >> 31)


def _mix32_py(x: int) -> int:
    x &= _MASK
    x ^= x >> 16
    x = (x * _M1) & _MASK
    x ^= x >> 13
    x = (x * _M2) & _MASK
    x ^= x >> 16
    return x


def derive_seed(base_seed: int, *path: int) -> int:
    """Derive a per-layer / per-matrix seed from a base seed and a path of
    integers (layer index, matrix slot, ...).  Pure Python."""
    h = base_seed & _MASK
    for p in path:
        key = (h ^ ((p & _MASK) * _GOLDEN)) & _MASK
        h = _mix32_py(key)
    return h
