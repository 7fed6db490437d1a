"""Top-k logit mask for the sampler: radix-select threshold.

Kernel: ``csrc/topk.cu`` (CUDA C++, sm_90a).  It replaces the JAX
package's ``kernels/topk.py`` ``_topk_kernel`` / ``topk_mask``: per row,
the k-th largest value is found exactly, without sorting, as the k-th
largest key under the monotone fp32 -> uint32 map (``-0.0`` canonicalised
to ``+0.0`` first, as the JAX ``_sortable`` does); values strictly below
it become ``fill``, boundary ties all survive, and ``k <= 0`` or
``k >= V`` leaves the row untouched.  The TPU kernel takes 32 one-bit
passes over a row held in VMEM.  A 151936-wide fp32 row (594 KB) does
not fit in one block's shared memory, so the CUDA kernel holds each row
in a thread-block cluster: every CTA loads a slice of the row once, and
the cluster selects the threshold an 8-bit digit at a time (four
passes), summing its CTAs' histograms over distributed shared memory; the mask is written from shared memory.  :func:`topk_plan` sizes
the cluster, the slices and the shared memory; a row too wide for its
cluster's shared memory streams its slice from global memory on every
pass.  What bounds it is bytes (one read and one write of the row) and
the latency of its passes.

The plain version :func:`topk_mask_ref` (the port of the JAX package's
``kernels/ref.py`` ``topk_mask_ref``) sorts each row.  The CPU path takes
it; on a CUDA tensor the wrapper launches the kernel or raises.  The
nucleus and min-p oracles (``topp_mask_ref``, ``minp_mask_ref``, ports
of ``ref.py``'s) hold the sampler's vectorized filters to a per-row walk.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG = -1e30

TOPK_THREADS = 512          # csrc TK_NT
CLUSTER_SIZES = (1, 2, 4, 8, 16)
# at most this much dynamic shared memory a CTA: the H100's 227 KB less
# what the kernel declares statically
SMEM_LIMIT = 232448 - 1024


def default_plan(b: int, v: int, dtype) -> int:
    """CTAs a row by default, from chip_smoke phase 3d's sweep on the
    H100 (PERF.md): 16 while the batch's clusters fit one wave in a few
    GPCs (b <= 4; at b = 8 clusters of 16 took two waves), 8 to b = 8, 4
    to b = 32, beyond that the fewest (2 or 4) that still hold the row in
    shared memory."""
    if b <= 4:
        return 16
    if b <= 8:
        return 8
    if b <= 32:
        return 4
    return next(c for c in (2, 4, 8, 16)
                if c == 16 or topk_plan(b, v, dtype, cluster=c).resident)


@dataclass(frozen=True)
class TopkPlan:
    """How one ``topk_mask`` launch runs: ``cluster`` CTAs a row, each
    holding ``slice`` values of it, ``resident`` when the slice sits in
    shared memory (else it streams from global memory on each pass), and
    ``shared_bytes`` of dynamic shared memory a CTA."""
    cluster: int
    slice: int
    resident: bool
    shared_bytes: int


# a CTA's histograms: one a warp, two buffers of its counts and the
# cluster's counts, 256 bins each (csrc TK_NB)
HIST_BYTES = (TOPK_THREADS // 32 + 3) * 256 * 4


def topk_plan(b: int, v: int, dtype=torch.float32, *,
              cluster: Optional[int] = None) -> TopkPlan:
    """The plan of ``topk_mask`` on (b, v) logits of ``dtype``.
    ``cluster`` forces the CTAs a row (chip_smoke sweeps them); by
    default :func:`default_plan`'s."""
    if dtype not in _build.DTYPE_CODE:
        raise ValueError(f"topk_mask: dtype {dtype} not supported")
    cluster = cluster or default_plan(b, v, dtype)
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster {cluster} not in {CLUSTER_SIZES}")
    # whole 16-byte copies a slice, so every CTA's slice stays aligned
    sl = max(8, -(-(-(-v // cluster)) // 8) * 8)
    row = sl * torch.finfo(dtype).bits // 8
    resident = HIST_BYTES + row <= SMEM_LIMIT
    return TopkPlan(cluster, sl, resident,
                    HIST_BYTES + (row if resident else 0))


def streaming_from(cluster: int, dtype) -> int:
    """The least row width whose slices no longer fit in shared memory:
    from there on ``topk_mask`` streams the row on every pass."""
    per = (SMEM_LIMIT - HIST_BYTES) // (
        torch.finfo(dtype).bits // 8) // 8 * 8
    return cluster * per + 1


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


def topk_mask(logits: torch.Tensor, k: torch.Tensor, fill: float = NEG, *,
              plan: Optional[TopkPlan] = None):
    """Mask each row of ``logits`` (B, V) to its top-``k[row]`` values
    (k (B,) int; ``k <= 0`` or ``k >= V`` disables the row).  ``plan``
    (default :func:`topk_plan`) sizes the cluster; ``topk_mask.resident``
    counts the launches that held their rows in shared memory."""
    if logits.device.type == "cpu":
        return topk_mask_ref(logits, k, fill)
    _build.require_cuda(logits, "topk_mask")
    if logits.dtype not in _build.DTYPE_CODE or logits.dim() != 2:
        raise ValueError("topk_mask: (B, V) float32 or bfloat16 logits")
    x = logits.contiguous()
    kk = k.to(device=x.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(x)
    b, v = x.shape
    plan = plan or topk_plan(b, v, x.dtype)
    fn = _build.bind("topk", "topk_mask",
                     [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                     + [ctypes.c_float] + [ctypes.c_int] * 5
                     + [ctypes.c_void_p])
    rc = fn(_build.ptr(x), _build.ptr(out), _build.ptr(kk), b, v,
            float(fill), _build.DTYPE_CODE[x.dtype], plan.cluster,
            plan.slice, int(plan.resident),
            plan.shared_bytes, _build.stream_of(x))
    _build.check(rc, "topk_mask")
    topk_mask.launches += 1
    topk_mask.resident += int(plan.resident)
    return out


topk_mask.launches = 0
topk_mask.resident = 0


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
