"""Gradient compression with error feedback, PyTorch port of the JAX
package's ``train/grad_compress.py`` (the same arithmetic, leaf by leaf).

Two compressors, both carrying a residual to the next step (error
feedback), applied by the train step before the optimizer:

1. ``hashed_space`` — the paper's own math applied to gradients: a dense
   gradient is feature-hashed into R^K with (h, xi) (paper Eq. 5/6),
   exchanged as the K-vector and decompressed with the same hash,

       g_hat[i] = xi(i) * G[h(i)] / count[h(i)],
       G[k] = sum_{i: h(i)=k} xi(i) g[i],

   and the residual (g - g_hat) is carried to the next step.
2. ``int8`` — per-tensor max-scaled int8 quantization: 4x (vs fp32) / 2x
   (vs bf16) fewer bytes on the wire.

Leaves below ``min_size`` (norms, biases, small banks) pass through.
Each sketched leaf hashes with seed ``0xFEED ^ li``, ``li`` its index in
sorted-key order (``optimizer.tree_leaves``, which is JAX's flatten
order for dicts).  The sketch's bucket indices (int32) and signs (int8)
are computed in chunks and cached per (n, k, seed, device): the
full-width embedding gradient has 311 M entries.  ``index_add_`` on the
card sums in no fixed order, so the sketch there is deterministic only
up to fp32 rounding.  What the exchange itself would cost is
:func:`wire_bytes`; one device exchanges nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.train.optimizer import tree_leaves, tree_map, tree_unflatten

_CHUNK = 1 << 24    # sketch indices hashed this many at a time


# ---------------------------------------------------------------------------
# error-feedback state
# ---------------------------------------------------------------------------

def init_residual(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


# ---------------------------------------------------------------------------
# int8 with error feedback
# ---------------------------------------------------------------------------

def int8_compress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    g32 = g.float()
    scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def int8_roundtrip(g, residual):
    """(compressed->decompressed grad, new residual). EF: compress g+r."""
    target = g.float() + residual
    q, scale = int8_compress(target)
    approx = int8_decompress(q, scale)
    return approx.to(g.dtype), target - approx


# ---------------------------------------------------------------------------
# hashed-space sketch (paper Eq. 5/6 applied to gradients)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SketchSpec:
    n: int            # dense gradient length (flattened)
    k: int            # sketch buckets
    seed: int = 0


_SKETCH: Dict[tuple, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}


def sketch_tables(spec: SketchSpec, device):
    """(idx int32 (n,), sgn int8 (n,), counts fp32 (k,)) of ``spec`` on
    ``device``: bucket h(i, 0), sign xi(i, 0) and the entries a bucket
    holds, hashed ``_CHUNK`` entries at a time and cached."""
    key = (spec, str(device))
    if key not in _SKETCH:
        if spec.n >= 2 ** 31:
            raise ValueError(f"sketch of {spec.n} entries: int32 indices")
        idx = torch.empty(spec.n, dtype=torch.int32, device=device)
        sgn = torch.empty(spec.n, dtype=torch.int8, device=device)
        for s in range(0, spec.n, _CHUNK):
            i = torch.arange(s, min(s + _CHUNK, spec.n), dtype=torch.int64,
                             device=device)
            idx[s:s + len(i)] = hashing.bucket_hash(i, 0, spec.k, spec.seed)
            sgn[s:s + len(i)] = hashing.sign_hash(i, 0, spec.seed)
        counts = torch.bincount(idx, minlength=spec.k).float()
        _SKETCH[key] = (idx, sgn, counts)
    return _SKETCH[key]


def sketch_compress(g: torch.Tensor, spec: SketchSpec) -> torch.Tensor:
    """g (n,) -> G (k,): G[c] = sum_{i: h(i)=c} xi(i) g[i]."""
    idx, sgn, _ = sketch_tables(spec, g.device)
    flat = g.float().reshape(-1) * sgn
    return torch.zeros(spec.k, dtype=torch.float32,
                       device=g.device).index_add_(0, idx, flat)


def sketch_decompress(G: torch.Tensor, spec: SketchSpec, shape,
                      normalize: bool = False) -> torch.Tensor:
    """G (k,) -> g_hat (n,): g_hat[i] = xi(i) G[h(i)].

    normalize=False: the classic count-sketch estimate.  normalize=True
    divides by bucket counts, so that decompress(compress(.)) is the
    orthogonal projection onto per-bucket sign directions (idempotent,
    non-expansive): the choice that keeps iterated error feedback stable
    (see the JAX package's docstring)."""
    idx, sgn, counts = sketch_tables(spec, G.device)
    if normalize:
        G = G / torch.clamp(counts, min=1.0)
    return (G.index_select(0, idx) * sgn).reshape(shape)


def sketch_roundtrip(g, residual, compression: float, seed: int):
    """(approx grad, new residual) through the hashed sketch with EF."""
    n = int(np.prod(g.shape))
    k = max(1, int(round(compression * n)))
    spec = SketchSpec(n=n, k=k, seed=seed)
    target = g.float() + residual
    G = sketch_compress(target.reshape(-1), spec)
    approx = sketch_decompress(G, spec, g.shape, normalize=True)
    return approx.to(g.dtype), target - approx


# ---------------------------------------------------------------------------
# tree-level transform
# ---------------------------------------------------------------------------

def make_compressor(kind: str, compression: float = 0.125,
                    min_size: int = 65536) -> Callable:
    """Returns compress_tree(grads, residuals) -> (grads', residuals').

    Tensors smaller than min_size (norms, biases, hashed banks — already
    compressed by the paper's technique) pass through untouched.
    kind: "none" | "int8" | "hashed_space"
    """
    if kind not in ("none", "int8", "hashed_space"):
        raise ValueError(kind)

    def compress_tree(grads, residuals):
        out_g, out_r = [], []
        for li, (g, r) in enumerate(zip(tree_leaves(grads),
                                        tree_leaves(residuals))):
            if kind == "none" or g.numel() < min_size:
                ng, nr = g, r
            elif kind == "int8":
                ng, nr = int8_roundtrip(g, r)
            else:
                ng, nr = sketch_roundtrip(g, r, compression,
                                          seed=0xFEED ^ li)
            out_g.append(ng)
            out_r.append(nr)
        return (tree_unflatten(grads, out_g),
                tree_unflatten(residuals, out_r))

    return compress_tree


def wire_bytes(grads, kind: str, compression: float = 0.125,
               min_size: int = 65536) -> int:
    """Bytes a cross-device exchange of `grads` would put on the wire."""
    total = 0
    for g in tree_leaves(grads):
        n = g.numel()
        if kind == "none" or n < min_size:
            total += n * g.element_size()
        elif kind == "int8":
            total += n + 4
        elif kind == "hashed_space":
            total += max(1, int(round(compression * n))) * 4
    return total
