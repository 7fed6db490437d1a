"""Batched ragged flash-prefill: every prefilling row's chunk in one
dispatch, attending its own paged prefix.

Kernel: ``csrc/flash_prefill.cu`` (CUDA C++, sm_90a).  It replaces the
JAX package's ``kernels/flash_prefill.py`` ``_prefill_kernel`` /
``paged_prefill_attention``.  One block per (query tile, kv head, row)
walks just the positions its tile can see, staging K and V once for the
G query heads of one kv head (GQA without repeating K/V), with an online
softmax.  bf16 (the serving path) runs FlashAttention-2 on the tensor
cores: 64 query rows a block, one warp per 16, ``mma.sync`` with bf16
operands and fp32 accumulators for both ``Q K^T`` and ``P V`` (the
probabilities rounded to bf16), K/V copied by ``cp.async`` into a double
buffer.  fp32 keeps the CUDA-core version (full fp32 products, 32 rows a
block).  Slot ``s`` of row ``b`` sits at position ``starts[b] + s``;
slots at or past ``counts[b]`` and rows with ``counts == 0`` give zeros.

The plain version :func:`paged_prefill_ref` (the port of the JAX
package's ``kernels/ref.py`` ``paged_prefill_ref``) gathers the table
and attends.  The CPU path takes it; on a CUDA tensor the wrapper
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG = -1e30


def paged_prefill_ref(q, pages_k, pages_v, page_table, starts, counts,
                      window=0):
    """Ragged batched prefill attention, gather-then-attend.

    q (B, S, Hq, D) rotated, scaled by 1/sqrt(D) here; pages_k/v
    (P, ps, Hkv, D) already holding the chunk's K/V; page_table
    (B, MAXP) int32; starts (B,) first query position of each row's
    chunk; counts (B,) real query slots, 0 disables the row; window 0
    disables.  Returns (B, S, Hq, D) in q.dtype; pad slots are zero.
    """
    if q.is_cuda:
        paged_prefill_ref.cuda_calls += 1
    b, s, hq, d = q.shape
    _, ps, n_kv, _ = pages_k.shape
    g = hq // n_kv
    table = page_table.long()
    t = table.shape[1] * ps
    k = pages_k[table].reshape(b, t, n_kv, d)
    v = pages_v[table].reshape(b, t, n_kv, d)
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, s, n_kv, g, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float() * scale, k.float())
    dev = q.device
    starts, counts = starts.long(), counts.long()
    kv_pos = torch.arange(t, device=dev)[None, None, :]
    slot = torch.arange(s, device=dev)[None, :]
    q_pos = (starts[:, None] + slot)[:, :, None]
    end = (starts + counts)[:, None, None]
    valid = (kv_pos <= q_pos) & (kv_pos < end) \
        & (slot < counts[:, None])[:, :, None]
    if window > 0:
        valid = valid & (q_pos - kv_pos < window)
    vmask = valid[:, None, None, :, :]
    scores = torch.where(vmask, scores, torch.tensor(NEG, device=dev))
    probs = torch.softmax(scores, dim=-1)
    # pad query slots (and count-0 rows) are fully masked: zero them
    probs = torch.where(vmask, probs, 0.0)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(b, s, hq, d).to(q.dtype)


paged_prefill_ref.cuda_calls = 0


def paged_prefill_attention(q, pages_k, pages_v, page_table, starts, counts,
                            window: int = 0):
    """Ragged batched prefill attention through a paged KV cache.

    q: (B, S, Hq, D) chunk queries, rotated to positions ``starts[b] + s``;
    pages_k/v: (P, page_size, Hkv, D) with the chunk's K/V already
    scattered into each row's pages; page_table: (B, MAXP) int32;
    starts/counts: (B,) int32; window: 0 disables.  Returns
    (B, S, Hq, D) in q.dtype; pad slots are zero.
    """
    if q.device.type == "cpu":
        return paged_prefill_ref(q, pages_k, pages_v, page_table, starts,
                                 counts, window)
    _build.require_cuda(q, "paged_prefill_attention")
    b, s, hq, d = q.shape
    npages, ps, n_kv, dk = pages_k.shape
    if dk != d or hq % n_kv or pages_v.shape != pages_k.shape:
        raise ValueError(f"paged_prefill_attention: q {tuple(q.shape)} vs "
                         f"pages {tuple(pages_k.shape)}")
    g = hq // n_kv
    if d not in (64, 128, 256) or 32 % g:
        raise ValueError(f"paged_prefill_attention: head_dim {d} / group "
                         f"{g} not compiled (head_dim 64/128/256, group "
                         f"dividing 32)")
    if q.dtype not in _build.DTYPE_CODE or pages_k.dtype != q.dtype \
            or pages_v.dtype != q.dtype:
        raise ValueError("paged_prefill_attention: q and pages must share "
                         "dtype float32 or bfloat16")
    q = _build.aligned16(q.contiguous())
    if not (pages_k.is_contiguous() and pages_v.is_contiguous()):
        raise ValueError("paged_prefill_attention: page pools must be "
                         "contiguous")
    if pages_k.data_ptr() % 16 or pages_v.data_ptr() % 16:
        raise ValueError("paged_prefill_attention: page pools must start "
                         "on a 16-byte boundary")
    dev = q.device
    table = page_table.to(device=dev, dtype=torch.int32).contiguous()
    st = starts.to(device=dev, dtype=torch.int32).contiguous()
    cn = counts.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    fn = _build.bind("flash_prefill", "paged_prefill",
                     [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                     + [ctypes.c_void_p])
    rc = fn(_build.ptr(q), _build.ptr(pages_k), _build.ptr(pages_v),
            _build.ptr(table), _build.ptr(st), _build.ptr(cn),
            _build.ptr(out), b, s, n_kv, g, d, table.shape[1], ps,
            int(window), _build.DTYPE_CODE[q.dtype], _build.stream_of(q))
    _build.check(rc, "paged_prefill")
    paged_prefill_attention.launches += 1
    # the library runs the tensor-core kernel for bf16, CUDA cores for fp32
    paged_prefill_attention.tensor_core += int(q.dtype == torch.bfloat16)
    return out


paged_prefill_attention.launches = 0
paged_prefill_attention.tensor_core = 0
