"""Synthetic language-model token stream + host-sharded batching.

The PyTorch port's own copy of the JAX package's ``data/lm_stream.py``
(numpy only), so both packages train on bitwise the same batches.

The LM examples and integration tests need a *learnable* token stream with
no external corpus.  We generate a deterministic order-2 Markov source over
the vocabulary: transition logits are a pure function of (seed, prev2,
prev1) via the same stateless mixers the paper's technique uses, so the
stream is (a) reproducible across hosts, (b) genuinely predictable — a
model that learns reduces cross-entropy well below log(V).

Host sharding: each process draws disjoint sample indices
(sample_id = global_step * num_hosts + host_id), so the global batch is
i.i.d. across the fleet with zero coordination.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def _mix(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    x ^= x >> np.uint64(16)
    x *= np.uint64(0x85EBCA6B)
    x &= np.uint64(0xFFFFFFFF)
    x ^= x >> np.uint64(13)
    x *= np.uint64(0xC2B2AE35)
    x &= np.uint64(0xFFFFFFFF)
    x ^= x >> np.uint64(16)
    return x


def markov_sequences(seed: int, n: int, seq_len: int, vocab: int,
                     branch: int = 4) -> np.ndarray:
    """(n, seq_len+1) int32 token sequences from a hashed order-2 chain.

    Each (prev2, prev1) context has `branch` plausible successors chosen by
    hashing; the sampler picks among them with a fixed skewed distribution.
    Entropy ~ log(branch) * H(skew) << log(vocab).
    """
    rng = np.random.default_rng(np.random.SeedSequence([seed, n, seq_len]))
    out = np.empty((n, seq_len + 1), np.int64)
    out[:, 0] = rng.integers(0, vocab, size=n)
    out[:, 1] = rng.integers(0, vocab, size=n)
    # skewed choice over branch successors: p ~ 0.55, 0.25, 0.12, 0.08...
    probs = np.array([0.55, 0.25, 0.12, 0.08][:branch])
    probs = probs / probs.sum()
    for t in range(2, seq_len + 1):
        ctx = (out[:, t - 2] * np.int64(vocab) + out[:, t - 1])
        pick = rng.choice(branch, size=n, p=probs)
        h = _mix(ctx.astype(np.uint64) * np.uint64(2654435761)
                 + np.uint64(seed) + pick.astype(np.uint64)
                 * np.uint64(0x9E3779B9))
        out[:, t] = (h % np.uint64(vocab)).astype(np.int64)
    return out.astype(np.int32)


def batches(seed: int, batch: int, seq_len: int, vocab: int,
            host_id: int = 0, num_hosts: int = 1,
            start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite iterator of {tokens (B,S), targets (B,S)} for this host."""
    step = start_step
    while True:
        sample_seed = seed * 1_000_003 + step * num_hosts + host_id
        seqs = markov_sequences(sample_seed, batch, seq_len, vocab)
        yield {"tokens": seqs[:, :-1], "targets": seqs[:, 1:]}
        step += 1
