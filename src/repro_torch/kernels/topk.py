"""Top-k logit mask for the sampler: radix-select threshold.

Kernel: ``csrc/topk.cu`` (CUDA C++, sm_90a).  It replaces the JAX
package's ``kernels/topk.py`` ``_topk_kernel`` / ``topk_mask``: per row,
the k-th largest value is found exactly, without sorting, as the k-th
largest key under the monotone fp32 -> uint32 map (``-0.0`` canonicalised
to ``+0.0`` first, as the JAX ``_sortable`` does); values strictly below
it become ``fill``, boundary ties all survive, and ``k <= 0`` or
``k >= V`` leaves the row untouched.  The TPU kernel takes 32 one-bit
passes over a row held in VMEM; a 151936-wide fp32 row (594 KB) does not
fit in shared memory, so the CUDA kernel streams it from L2 and takes
four eight-bit passes (a 256-bin histogram each).  What bounds it is
bytes: five reads and one write of the row against the one read and one
write the function needs.

The plain version :func:`topk_mask_ref` (the port of the JAX package's
``kernels/ref.py`` ``topk_mask_ref``) sorts each row.  The CPU path takes
it; on a CUDA tensor the wrapper launches the kernel or raises.  The
nucleus and min-p oracles (``topp_mask_ref``, ``minp_mask_ref``, ports
of ``ref.py``'s) hold the sampler's vectorized filters to a per-row walk.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG = -1e30


def topk_mask_ref(logits: torch.Tensor, k: torch.Tensor, fill=NEG):
    """Per-row k-th-largest threshold by a full sort (the plain version).
    Comparisons on the fp32 view; survivors pass through unchanged."""
    if logits.is_cuda:
        topk_mask_ref.cuda_calls += 1
    b, v = logits.shape
    x32 = logits.float()
    k = k.to(device=logits.device, dtype=torch.int64)
    srt = torch.sort(x32, dim=-1).values                # ascending
    thr = torch.gather(srt, 1, torch.clamp(v - k, 0, v - 1)[:, None])
    disabled = (k <= 0) | (k >= v)
    keep = disabled[:, None] | (x32 >= thr)
    return torch.where(keep, logits,
                       torch.tensor(fill, dtype=logits.dtype,
                                    device=logits.device))


topk_mask_ref.cuda_calls = 0


def topk_mask(logits: torch.Tensor, k: torch.Tensor, fill: float = NEG):
    """Mask each row of ``logits`` (B, V) to its top-``k[row]`` values
    (k (B,) int; ``k <= 0`` or ``k >= V`` disables the row)."""
    if logits.device.type == "cpu":
        return topk_mask_ref(logits, k, fill)
    _build.require_cuda(logits, "topk_mask")
    if logits.dtype not in _build.DTYPE_CODE or logits.dim() != 2:
        raise ValueError("topk_mask: (B, V) float32 or bfloat16 logits")
    x = logits.contiguous()
    kk = k.to(device=x.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(x)
    fn = _build.bind("topk", "topk_mask",
                     [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    rc = fn(_build.ptr(x), _build.ptr(out), _build.ptr(kk), x.shape[0],
            x.shape[1], float(fill), _build.DTYPE_CODE[x.dtype],
            _build.stream_of(x))
    _build.check(rc, "topk_mask")
    topk_mask.launches += 1
    return out


topk_mask.launches = 0


def topp_mask_ref(z: torch.Tensor, p, fill=NEG):
    """Oracle for nucleus filtering: a per-row walk down the descending
    probabilities.  A token survives iff its probability is >= that of
    the least probable member of the smallest prefix whose mass reaches
    p (the prefix-mass rule, which always keeps the top-1); p >= 1
    disables the row."""
    z32 = z.float()
    p = torch.as_tensor(p, dtype=torch.float64).tolist()
    out = z32.clone()
    for i in range(z32.shape[0]):
        if p[i] >= 1.0:
            continue
        probs = torch.softmax(z32[i], dim=-1)
        order = torch.argsort(-probs, stable=True).tolist()
        cum = torch.tensor(0.0)
        cutoff = probs[order[0]]
        pi = torch.tensor(p[i], dtype=torch.float32)
        for j in order:
            if cum < pi:                     # prefix mass so far < p: keep
                cutoff = probs[j]
                cum = cum + probs[j]
            else:
                break
        out[i] = torch.where(probs >= cutoff, z32[i],
                             torch.tensor(fill, dtype=torch.float32))
    return out.to(z.dtype)


def minp_mask_ref(z: torch.Tensor, min_p, fill=NEG):
    """Oracle for min-p filtering: tokens with probability below
    ``min_p * max_prob`` are dropped; ``min_p <= 0`` disables the row."""
    z32 = z.float()
    min_p = torch.as_tensor(min_p, dtype=torch.float32)
    out = z32.clone()
    for i in range(z32.shape[0]):
        if min_p[i] <= 0.0:
            continue
        probs = torch.softmax(z32[i], dim=-1)
        keep = probs >= min_p[i] * probs.max()
        out[i] = torch.where(keep, z32[i],
                             torch.tensor(fill, dtype=torch.float32))
    return out.to(z.dtype)
